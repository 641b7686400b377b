"""Seconds a round the card sits idle under the program's ``fl.eval``
span (the engine's ``evaluate(params)``), over the traced window's
rounds (``spans.idle_per``)."""
from portbench import spans


def read(rec):
    return spans.idle_per(rec, ["fl.eval"], "rounds")
