"""Seconds a round spends outside LocalTrain (eval, wire accounting,
aggregation, the dual step): the round span minus the ``run_round``
span, averaged over the traced window's rounds."""


def read(rec):
    rounds = rec["spans"].get("round", [])
    local = rec["spans"].get("localtrain", [])
    if not rounds or len(local) != len(rounds):
        return None
    return sum((r1 - r0) - (l1 - l0)
               for (r0, r1), (l0, l1) in zip(rounds, local)) / len(rounds)
