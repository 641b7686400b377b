"""Seeded TORCH003 violations: device work at import time."""
import torch

from repro_torch.kernels import cuda_lib

TABLE = torch.arange(16, device="cuda")   # TORCH003: tensor on the card
torch.cuda.synchronize()                  # TORCH003: touches the card
LIB = cuda_lib.load_library()             # TORCH003: builds the library
ONES = torch.ones(4).cuda()               # TORCH003: moved to the card


def lookup(i):
    return TABLE[i]
