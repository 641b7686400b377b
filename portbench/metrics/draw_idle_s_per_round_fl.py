"""Seconds a round the card sits idle under the program's ``fl.draw``
spans (the batched executor's ``_stack_batches``: every microbatch of a
knob group drawn on the host and copied over), over the traced
window's rounds (``spans.idle_per``)."""
from portbench import spans


def read(rec):
    return spans.idle_per(rec, ["fl.draw"], "rounds")
