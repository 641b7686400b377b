"""Clean REPRO001 pattern: the wrapper launches and counts."""
from repro_torch.kernels import cuda_lib


def _launch(x):
    cuda_lib.launch_on(0, "paired_kernel_launch", x)
    cuda_lib.LAUNCHES["paired_kernel"] += 1


def paired_kernel_bshd(x):
    _launch(x)
    return x
