"""Seconds a round the card sits idle in the self time of the program's
``fl.round`` and ``fl.localtrain`` spans: the round less its eval and
LocalTrain (composition, masks, aggregation, the dual step, the closing
synchronise), and LocalTrain less its draws, steps and wire (the
losses' read, and whatever wraps the executor), over the traced
window's rounds (``spans.idle_per``)."""
from portbench import spans


def read(rec):
    return spans.idle_per(rec, ["fl.round", "fl.localtrain"], "rounds")
