"""Seeded REPRO001 fixture: the kernels' launching wrappers."""
from repro_torch.kernels import cuda_lib


def _launch(entry, x):
    return cuda_lib.launch_on(0, entry, x)


def good_kernel(x):
    cuda_lib.launch_on(0, "good_kernel_launch", x)
    cuda_lib.LAUNCHES["good_kernel"] += 1


def no_extern(x):
    cuda_lib.launch_on(0, "no_extern_launch", x)


def no_counter(x):
    cuda_lib.launch_on(0, "no_counter_launch", x)


def no_twin(x):
    cuda_lib.launch_on(0, "no_twin_launch", x)


def _no_dispatch(x):
    cuda_lib.launch_on(0, "no_dispatch_launch", x)


def unused_wrapper(x):
    return _no_dispatch(x)


def twin_undispatched(x):
    cuda_lib.launch_on(0, "twin_undispatched_launch", x)


def no_test(x):
    cuda_lib.launch_on(0, "no_test_launch", x)
