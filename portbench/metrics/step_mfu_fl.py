"""The round's share of the card's fp32 peak: the model FLOPs of the
traced rounds' LocalTrain (``counts.train_flops``, frozen layers' weight
gradients left out) over the traced window times 67 TFLOP/s."""
from portbench import counts


def read(rec):
    tr = rec.get("trace")
    flops = rec["counts"].get("model_flops", 0)
    if not tr or not flops or tr["window_s"] <= 0 or not tr["ops"]:
        return None
    return 100.0 * flops / (tr["window_s"] * counts.PEAK_FP32)
