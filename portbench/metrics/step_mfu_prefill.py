"""The prefill's share of the card's bf16 peak: the model FLOPs of
the traced requests (``counts.forward_flops``: top-2 of 16 experts, causal
pairs) over the traced
window times 989 TFLOP/s."""
from portbench import counts


def read(rec):
    tr = rec.get("trace")
    flops = rec["counts"].get("model_flops", 0)
    if not tr or not flops or tr["window_s"] <= 0 or not tr["ops"]:
        return None
    return 100.0 * flops / (tr["window_s"] * counts.PEAK_BF16)
