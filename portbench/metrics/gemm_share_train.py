"""Matrix-multiply kernels' share of the traced device time: the
profiler's operations whose name the benchmark's list
(``counts.GEMM_KERNELS``) classes as a matrix multiply, over all
operations' device time."""
from portbench import counts


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["ops"]:
        return None
    total = sum(t - s for _, s, t in tr["ops"]) * 1e-9
    if total <= 0:
        return None
    return 100.0 * counts.kernel_seconds(tr["ops"],
                                         counts.GEMM_KERNELS) / total
