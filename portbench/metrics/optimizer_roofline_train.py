"""Share of the optimizer's roofline: the least bytes the window's AdamW
steps move (the program's counter ``optim.bytes``: each updated
element's gradient read, and its parameter and both moments read and
written, at their dtypes) over 3.35 TB/s, against the device seconds
between the CUDA events at the ends of the program's ``train.optimizer``
spans, summed over the traced window; None where the program counts no
bytes (a commit before the counter) or has no such span."""
from portbench import counts, spans


def read(rec):
    got = spans.program(rec)
    if got is None or not got["counters"].get("optim.bytes"):
        return None
    w0, w1 = rec["trace"]["window_ns"]
    seconds = sum(sp["device_s"] for sp in got["spans"]
                  if sp["name"] == "train.optimizer"
                  and sp["device_s"] is not None
                  and sp["end_ns"] > w0 and sp["start_ns"] < w1)
    if seconds <= 0:
        return None
    return 100.0 * got["counters"]["optim.bytes"] / counts.PEAK_HBM / seconds
