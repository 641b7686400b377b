"""Runtime sanitizers: host syncs and rebuilds in the port's round loop.

The static rules can't see dynamic behaviour: a round loop that waits on
the card at every step, or a kernel library that is rebuilt or reloaded
every round. These opt-in contexts pin both, as the reference's
transfer guard and recompile watcher do (``repro.analysis.runtime``):

``no_syncs()``              — ``torch.cuda.set_sync_debug_mode("error")``
                              as a context manager: any synchronising
                              CUDA call inside raises.
``SyncGuardCallback``       — engine ``RoundCallback`` recording, from
                              ``from_round`` on, every synchronising CUDA
                              call of each round by its Python call site
                              (``file:function``), under mode "warn" with
                              the warnings captured; ``faults()`` are the
                              steady-state syncs outside ``EXPLICIT_READS``.
``RecompileWatcher``        — counts what the port builds at run time:
                              builds and loads of the kernel library
                              (``kernels.cuda_lib``) and any
                              ``torch._dynamo`` compile; ``mark()`` buckets
                              them (e.g. per round).
``RecompileWatchCallback``  — engine ``RoundCallback`` recording the count
                              of every round.

Where ``jax.transfer_guard`` forbids implicit transfers and allows
explicit ones, torch's sync debug mode flags every synchronising call
alike (a ``.item()``, a ``.cpu()``, a copy from pageable host memory, a
``torch.cuda.synchronize``). So the deliberate host reads of the round
loop are listed in ``EXPLICIT_READS``, each with its reason; any other
site that syncs in a steady-state round is the fault.

On a machine without CUDA the sync debug mode is inert: ``no_syncs``
and ``SyncGuardCallback`` keep their bookkeeping and record nothing.
Every mode change is undone in a ``finally`` or in ``close()``.
"""
from __future__ import annotations

import contextlib
import os
import sys
import warnings
from collections import Counter
from typing import Dict, Iterator, List, Optional

import torch

from repro_torch.fl.callbacks import RoundCallback
from repro_torch.kernels import cuda_lib

#: the text of torch's warning (mode "warn") and error (mode "error")
SYNC_MESSAGE = "called a synchronizing CUDA operation"

#: the port's deliberate host syncs on its round loops, by call site
#: (``file:function`` under ``src/repro_torch``), each with its reason
EXPLICIT_READS: Dict[str, str] = {
    "core/client.py:train_client":
        "the client's mean loss, read once per client; the grad-accum "
        "divisor staged as a 0-d tensor at each local step",
    "core/client.py:sample_batch":
        "each microbatch staged from the host's per-client NumPy stream",
    "core/client.py:_masked_wire_mb":
        "the freezing mask read per leaf for exact-integer wire bytes",
    "core/freezing.py:mask_tree":
        "a new k's freezing mask staged once, then cached per k",
    "core/freezing.py:count_active":
        "a new k's active-parameter count, once per k",
    "core/server.py:evaluate":
        "each eval batch's loss read for the round record",
    "core/aggregation.py:aggregate":
        "the combine's fp32 weights staged as 0-d tensors",
    "fl/executor.py:_train_group":
        "the batched executor's per-client losses, one read per group",
    "fl/executor.py:_stack_batches":
        "a group's microbatches staged from the host streams",
    "fl/aggregator.py:_scale_delta":
        "a staleness discount staged as a 0-d fp32 tensor",
    "fl/aggregator.py:_quantize":
        "the masked aggregator's fixed point runs on the host, as the "
        "reference's does: each delta leaf read once",
    "fl/aggregator.py:flush":
        "the masked mean's leaves sent back to the deltas' device",
    "kernels/ops.py:masked_sum_u64":
        "the masked cohort's uint64 bits in, the sum out: one round "
        "trip per fold",
}

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
_SKIP_FILES = (os.path.abspath(__file__), os.path.abspath(warnings.__file__))


def sync_debug_supported() -> bool:
    """The sync debug mode exists only with CUDA."""
    return torch.cuda.is_available()


@contextlib.contextmanager
def no_syncs() -> Iterator[None]:
    """Any synchronising CUDA call inside the block raises
    ``RuntimeError``. Inert without CUDA."""
    if not sync_debug_supported():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def call_site(frame=None) -> str:
    """``file:function`` of the innermost Python frame outside torch,
    ``warnings`` and this module: under ``src/repro_torch`` its path
    relative to the package, else the file's name."""
    f = frame if frame is not None else sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path not in _SKIP_FILES and not path.startswith(_TORCH_DIR):
            break
        f = f.f_back
    if f is None:
        return "<torch>"
    path = os.path.abspath(f.f_code.co_filename)
    if path.startswith(_PACKAGE_DIR + os.sep):
        rel = os.path.relpath(path, _PACKAGE_DIR).replace(os.sep, "/")
    else:
        rel = os.path.basename(path)
    return f"{rel}:{f.f_code.co_name}"


class SyncRecorder:
    """Counts synchronising CUDA calls by call site between ``start()``
    and ``stop()`` (mode "warn", its warnings captured and not shown).
    Inert without CUDA."""

    def __init__(self):
        self.supported = sync_debug_supported()
        self.counts: Counter = Counter()
        self._catch: Optional[warnings.catch_warnings] = None
        self._prev_mode = 0
        self._prev_show = None

    def start(self) -> None:
        if not self.supported or self._catch is not None:
            return
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.filterwarnings("always", message=SYNC_MESSAGE)
        self._prev_show = warnings.showwarning
        warnings.showwarning = self._show
        self._prev_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if str(message).startswith(SYNC_MESSAGE):
            self.counts[call_site(sys._getframe(1))] += 1
        else:
            self._prev_show(message, category, filename, lineno, file, line)

    def stop(self) -> None:
        if self._catch is None:
            return
        try:
            torch.cuda.set_sync_debug_mode(self._prev_mode)
        finally:
            catch, self._catch = self._catch, None
            catch.__exit__(None, None, None)


class SyncGuardCallback(RoundCallback):
    """Records every synchronising CUDA call of rounds >= ``from_round``
    by call site (``per_round[t]``: site -> count).

    Round 1 stays unrecorded: it builds the kernel library, the freezing
    masks and the eval batches. From ``from_round`` on, a sync from a
    site outside ``allowed`` (default ``EXPLICIT_READS``) is a fault
    (``faults()``). The mode is restored at ``on_train_end``; ``close()``
    is idempotent and belongs in a ``finally``, so an engine exception
    cannot leak the mode into later work."""

    def __init__(self, from_round: int = 2,
                 allowed: Optional[Dict[str, str]] = None):
        self.from_round = from_round
        self.allowed = EXPLICIT_READS if allowed is None else allowed
        self.guarded_rounds: List[int] = []
        self.per_round: Dict[int, Dict[str, int]] = {}
        self._recorder: Optional[SyncRecorder] = None
        self._round: Optional[int] = None

    def on_round_start(self, engine, rnd: int) -> None:
        self._close_round()
        if rnd >= self.from_round:
            self.guarded_rounds.append(rnd)
            self._round = rnd
            self._recorder = SyncRecorder()
            self._recorder.start()

    def _close_round(self) -> None:
        rec, self._recorder = self._recorder, None
        if rec is None:
            return
        rec.stop()
        if rec.supported:
            self.per_round[self._round] = dict(rec.counts)

    def on_train_end(self, engine, result) -> None:
        self.close()

    def close(self) -> None:
        self._close_round()

    def faults(self) -> Dict[int, Dict[str, int]]:
        """Per guarded round, the syncing sites outside ``allowed``."""
        out = {}
        for rnd, sites in self.per_round.items():
            bad = {s: n for s, n in sites.items() if s not in self.allowed}
            if bad:
                out[rnd] = bad
        return out


# ---------------------------------------------------------------------------
# rebuild / recompile watching
# ---------------------------------------------------------------------------


def compile_count() -> int:
    """What this process has built so far: kernel-library builds and
    loads, plus ``torch._dynamo``'s compiled graphs when dynamo was ever
    imported (it counts nothing otherwise, and is not imported here)."""
    n = cuda_lib.LIBRARY_EVENTS["builds"] + cuda_lib.LIBRARY_EVENTS["loads"]
    dynamo = sys.modules.get("torch._dynamo.utils")
    if dynamo is not None:
        n += int(dynamo.counters["stats"]["unique_graphs"])
    return n


class RecompileWatcher:
    """Counts builds / loads / compiles between marks.

    >>> w = RecompileWatcher()
    >>> with w:                     # doctest: +SKIP
    ...     step()                  # round 1: may load the library
    ...     w.mark("round1")
    ...     step()                  # round 2: nothing to build
    ...     w.mark("round2")
    >>> w.buckets                   # doctest: +SKIP
    {'round1': 1, 'round2': 0}
    """

    def __init__(self):
        self.buckets: Dict[str, int] = {}
        self._start: Optional[int] = None
        self._last: int = 0

    def __enter__(self) -> "RecompileWatcher":
        self._start = self._last = compile_count()
        return self

    def __exit__(self, *exc) -> None:
        pass

    def mark(self, label: str) -> int:
        """Close a bucket: events since the previous mark (or enter)."""
        now = compile_count()
        delta = now - self._last
        self._last = now
        self.buckets[label] = self.buckets.get(label, 0) + delta
        return delta

    @property
    def total(self) -> int:
        base = self._start if self._start is not None else 0
        return compile_count() - base


class RecompileWatchCallback(RoundCallback):
    """Records per-round build / load / compile counts during an engine
    run: ``per_round[t]`` = events while round ``t`` executed (its
    evaluation included). The steady-state pin is ``0`` after round 1.
    Unlike the reference's jit count, round 1 may show 0 too: the
    library may already be loaded in the process."""

    def __init__(self):
        self.watcher = RecompileWatcher()
        self.per_round: Dict[int, int] = {}
        self._round: Optional[int] = None

    def on_train_start(self, engine) -> None:
        self.watcher.__enter__()
        self._round = None

    def on_round_start(self, engine, rnd: int) -> None:
        if self._round is not None:
            self.per_round[self._round] = self.watcher.mark(
                f"round{self._round}")
        else:
            self.watcher.mark("setup")
        self._round = rnd

    def on_train_end(self, engine, result) -> None:
        if self._round is not None:
            self.per_round[self._round] = self.watcher.mark(
                f"round{self._round}")
            self._round = None

    def steady_state_compiles(self, first_steady_round: int = 2) -> int:
        return sum(c for t, c in self.per_round.items()
                   if t >= first_steady_round)
