"""Share of the flash kernel's roofline: the least time its calls could
take on the card (``counts.flash_bound_seconds``: admitted causal pairs'
FLOPs over 989 TFLOP/s or q, k, v and the output once over 3.35 TB/s,
the larger, summed over the traced requests' layers), against the
profiler's device time of the flash kernels."""
from portbench import counts


def read(rec):
    tr = rec.get("trace")
    bound = rec["counts"].get("flash_bound_s", 0)
    if not tr or not bound:
        return None
    seconds = counts.kernel_seconds(tr["ops"], counts.FLASH_KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * bound / seconds
