"""``moe.grouped_mm`` with the rows it leaves unwritten made NaN, for the
tests of ``repro_torch.models.moe`` on the CPU and on a card: the rows
past the experts' last end in its output, and in the gradient it passes
back to its input (on the card ``torch._grouped_mm`` leaves both to
whatever the allocator held; the CPU's twin writes 0)."""
import torch


class _Unwritten(torch.autograd.Function):
    """NaN past row ``end``: in the value (``grad`` False) or in the
    gradient that flows back (True)."""

    @staticmethod
    def forward(ctx, t, end, grad):
        ctx.end, ctx.grad = end, grad
        t = t.clone()
        if not grad:
            t[end:] = float("nan")
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        if ctx.grad:
            g[ctx.end:] = float("nan")
        return g, None, None


def unwritten(grouped_mm):
    """``grouped_mm`` (a, w, offs) -> the same, NaN where it writes
    nothing."""
    def run(a, w, offs):
        end = int(offs[-1])
        a = _Unwritten.apply(a, end, True)
        return _Unwritten.apply(grouped_mm(a, w, offs), end, False)
    return run
