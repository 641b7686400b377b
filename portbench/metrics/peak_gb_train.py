"""The card's peak allocated memory over the run (set-up, the traced
steps and all), in GB (1e9 bytes): ``torch.cuda.max_memory_allocated``
after the harness reset its statistics at the start."""


def read(rec):
    peak = rec.get("memory_peak_bytes", 0)
    if not peak or not rec.get("trace"):
        return None
    return peak / 1e9
