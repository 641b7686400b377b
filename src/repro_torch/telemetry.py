"""The port's own spans and counters, on while a ``torch.profiler``
session runs.

    from repro_torch import telemetry

    with telemetry.span("fl.round"):
        ...
    telemetry.count("moe.slots", n)           # a number or a 0-d tensor

There is no flag of its own: ``span`` and ``count`` record exactly while
a profiler session runs (``torch.profiler.profile``, or the autograd
profiler it wraps), so an operator who profiles any entry point gets
them, and nothing else does. Off, a span is one flag read and a shared
null context: it records nothing and enters no ``record_function``.

On, a span

- stamps its start and end with ``time.time_ns()``, the unix clock the
  profiler's own events are stamped on (kineto converts its clock to
  it), so the spans share the device trace's timeline;
- records its parent (the innermost span open on the same thread) and
  its root, the outermost span: a round, a request or a step;
- enters ``record_function(name)``, so it shows in the profiler's trace;
- once CUDA is initialised, records a timing CUDA event on the current
  stream at each end, so that its device interval is known without a
  synchronise.

A span left by an exception is closed all the same. ``count`` adds a
number on the host, or a 0-d tensor on the tensor's device (no host
read). ``collect()`` resolves the CUDA events and the device counters
(one synchronise) once the window is over and returns everything kept;
``reset()`` clears it. Spans stay in memory: there is no exporter.

Spans in the program (name: where; what it covers):

    fl.round          fl/engine.py: a round's own work, from the eval to
                      the closing synchronise (the round hooks outside)
    fl.eval           fl/engine.py: the round's ``evaluate(params)``
    fl.localtrain     fl/engine.py: ``executor.run_round``
    fl.draw           fl/executor.py ``_stack_batches``; core/client.py
                      a local step's ``sample_batch`` calls
    fl.step           fl/executor.py ``_train_stack``; core/client.py a
                      local step's gradients and update
    fl.wire           fl/executor.py a group's ``finalize_delta`` and
                      ``_masked_wire_mb``; core/client.py the same
    serve.prefill     launch/steps.py ``prefill_step``
    model.moe         models/moe.py ``moe_apply``
    train.accumulate  launch/steps.py the gradient accumulator: its fp32
                      zeros, the adds after each microbatch, the scale
    train.optimizer   launch/steps.py ``optimizer.update_``

Counters: ``moe.pairs_kept`` (real tokens' kept (token, expert) pairs,
a device sum) and ``moe.slots`` (groups x experts x capacity), both in
``moe_apply``; ``moe.rows`` (the rows the experts' grouped products run
over, one per kept pair of a real token, a device sum), in
``moe._expert_rows``; ``optim.bytes`` (the least bytes AdamW's steps
move: each updated element's gradient read, its parameter and both
moments read and written, a host number), in ``optim.optimizers``'
AdamW ``update_``.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


def enabled() -> bool:
    """Whether a profiler session runs (a module attribute read: torch
    sets it as a session starts and clears it as it ends)."""
    return _autograd_profiler._is_profiler_enabled


@dataclass
class SpanRecord:
    """One closed span: host stamps in unix ns, the device interval's
    seconds between its CUDA events (None without CUDA, or until
    ``collect``)."""
    name: str
    id: int
    parent: Optional[int]
    root: int
    start_ns: int = 0
    end_ns: int = 0
    device_s: Optional[float] = None
    events: Any = None


class Tracer:
    """The spans and counters of one process (``TRACER``)."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.counters: Dict[str, float] = {}
        self._device_counters: Dict[str, torch.Tensor] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> List[SpanRecord]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def count(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            value = value.detach()
            with self._lock:
                acc = self._device_counters.get(name)
                self._device_counters[name] = (value.clone() if acc is None
                                               else acc + value)
        else:
            with self._lock:
                self.counters[name] = self.counters.get(name, 0.0) + value

    def collect(self) -> Dict[str, Any]:
        """Resolve what is pending (CUDA events, device counters) and
        return {"spans": [dict per closed span, in closing order],
        "counters": {name: value}}."""
        with self._lock:
            pending = [r for r in self.spans if r.events is not None]
            if (pending or self._device_counters) \
                    and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            for r in pending:
                start, end = r.events
                r.device_s = start.elapsed_time(end) * 1e-3
                r.events = None
            for name, t in self._device_counters.items():
                self.counters[name] = (self.counters.get(name, 0.0)
                                       + float(t.item()))
            self._device_counters.clear()
            return {"spans": [{k: getattr(r, k) for k in (
                "name", "id", "parent", "root", "start_ns", "end_ns",
                "device_s")} for r in self.spans],
                "counters": dict(self.counters)}

    def reset(self) -> None:
        with self._lock:
            self.spans.clear()
            self.counters.clear()
            self._device_counters.clear()


class _Span:
    """A span while the profiler runs (see the module docstring)."""

    __slots__ = ("tracer", "name", "rec", "mark")

    def __init__(self, tracer: Tracer, name: str):
        self.tracer, self.name = tracer, name
        self.rec = self.mark = None

    def __enter__(self) -> SpanRecord:
        stack = self.tracer._stack()
        ident = next(self.tracer._ids)
        parent = stack[-1] if stack else None
        rec = self.rec = SpanRecord(
            self.name, ident, None if parent is None else parent.id,
            ident if parent is None else parent.root)
        stack.append(rec)
        rec.start_ns = time.time_ns()
        self.mark = _autograd_profiler.record_function(self.name)
        self.mark.__enter__()
        if torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            rec.events = (start, None)
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        try:
            if rec.events is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                rec.events = (rec.events[0], end)
            self.mark.__exit__(*exc)
        finally:
            rec.end_ns = time.time_ns()
            stack = self.tracer._stack()
            if stack and stack[-1] is rec:
                stack.pop()
            with self.tracer._lock:
                self.tracer.spans.append(rec)
        return False


#: the process's tracer
TRACER = Tracer()
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: a span named ``name`` while a profiler session
    runs, else a shared null context."""
    if not enabled():
        return _OFF
    return _Span(TRACER, name)


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a 0-d tensor summed on its device) to
    the counter ``name`` while a profiler session runs."""
    if enabled():
        TRACER.count(name, value)


def collect() -> Dict[str, Any]:
    """Every closed span and counter since the last ``reset``, resolved
    (see ``Tracer.collect``)."""
    return TRACER.collect()


def reset() -> None:
    TRACER.reset()
