"""The optimizer's share of the card's busy time: the device seconds
between the CUDA events at the ends of the program's ``train.optimizer``
spans (``optimizer.update_``), summed over the traced window, over its
busy seconds (``spans.device_share``)."""
from portbench import spans


def read(rec):
    return spans.device_share(rec, "train.optimizer")
