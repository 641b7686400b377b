"""Seeded TORCH001 violations: draws from torch's global generator."""
import torch
import torch.nn.functional as F


def init_weights(shape):
    torch.manual_seed(0)                  # TORCH001: global seeding
    w = torch.randn(shape)                # TORCH001: no generator=
    w.uniform_(-0.1, 0.1)                 # TORCH001: in-place global draw
    return w


def shuffle_clients(n):
    return torch.randperm(n)              # TORCH001: no generator=


def noisy(x):
    return F.dropout(x, 0.1)              # TORCH001: dropout's own draw
