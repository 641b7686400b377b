"""Share of the wire kernels' roofline: the bytes the quantizer and the
dequantizer need for the window's client deltas (``counts.wire_bytes``)
over 3.35 TB/s, against the profiler's device time of those kernels."""
from portbench import counts


def read(rec):
    tr = rec.get("trace")
    nbytes = rec["counts"].get("wire_bytes", 0)
    if not tr or not nbytes:
        return None
    seconds = counts.kernel_seconds(tr["ops"], counts.WIRE_KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * nbytes / counts.PEAK_HBM / seconds
