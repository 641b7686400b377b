"""The MoE layers' share of the card's busy time: the device seconds
between the CUDA events at the ends of the program's ``model.moe`` spans
(``models.moe.moe_apply``), summed over the traced window, over its
busy seconds (``spans.device_share``)."""
from portbench import spans


def read(rec):
    return spans.device_share(rec, "model.moe")
