"""Clean TORCH001 patterns: every draw takes an explicit generator."""
import torch


def init_weights(shape, seed):
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(shape, generator=gen)
    w.uniform_(-0.1, 0.1, generator=gen)
    return w


def shuffle_clients(n, gen):
    return torch.randperm(n, generator=gen)


def pick(rng, weights):
    return rng.multinomial(1, weights)    # a NumPy generator: fine
