"""Plain twin of the clean fixture kernel."""


def paired_kernel_ref(x):
    return x
