"""Clean REPRO001 pattern: a kernel with its whole contract."""
LAUNCHES = {"paired_kernel": 0}

_SIGNATURES = {
    "paired_kernel_launch": [],
}


def launch_on(index, name, *args):
    return 0
