"""Clean TORCH003 patterns: definitions at import, device work later."""
import functools

import torch

HAS_CARD = torch.cuda.is_available()      # a query, no device work
scale = functools.partial(torch.mul, other=2.0)


@functools.lru_cache(maxsize=None)
def table(device="cuda"):
    return torch.arange(16, device=device)   # inside a function: fine


def main():
    print(table())


if __name__ == "__main__":
    torch.cuda.synchronize()              # main guard: fine
    main()
