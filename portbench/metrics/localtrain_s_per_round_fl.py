"""Seconds of LocalTrain a round: the benchmark's span around the batched
executor's ``run_round``, averaged over the traced window's rounds."""


def read(rec):
    spans = rec["spans"].get("localtrain", [])
    if not spans:
        return None
    return sum(t - s for s, t in spans) / len(spans)
