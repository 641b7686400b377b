"""Seconds a round the card sits idle under the program's ``fl.wire``
spans (each client delta's ``finalize_delta`` and ``_masked_wire_mb``,
one client after another), over the traced window's rounds
(``spans.idle_per``)."""
from portbench import spans


def read(rec):
    return spans.idle_per(rec, ["fl.wire"], "rounds")
