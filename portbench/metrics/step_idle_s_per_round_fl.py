"""Seconds a round the card sits idle under the program's ``fl.step``
spans (the batched executor's ``_train_stack``: the vmapped gradients
and updates dispatched), over the traced window's rounds
(``spans.idle_per``)."""
from portbench import spans


def read(rec):
    return spans.idle_per(rec, ["fl.step"], "rounds")
