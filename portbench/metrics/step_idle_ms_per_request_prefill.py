"""Milliseconds a request the card sits idle under the program's
``serve.prefill`` span (``launch.steps`` ``prefill_step``, its MoE
layers included), over the traced window's requests
(``spans.idle_per``)."""
from portbench import spans


def read(rec):
    return spans.idle_per(rec, ["serve.prefill"], "requests", scale=1e3,
                          inclusive=True)
