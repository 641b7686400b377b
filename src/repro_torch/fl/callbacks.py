"""Round callbacks: side effects hooked out of the engine loop (logging,
checkpoints, history export, timing)."""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, List, Optional


class RoundCallback:
    """Override any subset; all hooks default to no-ops."""

    def on_train_start(self, engine) -> None:
        pass

    def on_round_start(self, engine, rnd: int) -> None:
        pass

    def on_round_composed(self, engine, plan) -> None:
        """The round's composition (a ``RoundPlan``) is fixed."""

    def on_server_update(self, engine, update) -> None:
        """An aggregator's ``ServerUpdate`` was applied;
        ``engine.params`` already includes it."""

    def on_dual_update(self, engine, rnd: int, constraint_reports) -> None:
        """The strategy's duals moved; ``constraint_reports`` maps each
        profile to its ``ConstraintReport`` list."""

    def on_round_end(self, engine, record) -> None:
        pass

    def on_train_end(self, engine, result) -> None:
        pass


class LoggingCallback(RoundCallback):
    """The reference's per-round log line, format preserved."""

    def __init__(self, log: Callable[[str], None] = print):
        self.log = log

    def on_round_end(self, engine, r) -> None:
        kn, rat, lam = r.knobs, r.ratios, r.duals
        if not kn:          # dynamics left the round with no cohort
            self.log(f"[{engine.strategy.name}] round {r.round:3d} "
                     f"val={r.val_loss:.4f} no clients reachable "
                     f"(available={r.num_available}) {r.seconds:.1f}s")
            return
        line = (
            f"[{engine.strategy.name}] round {r.round:3d} "
            f"val={r.val_loss:.4f} "
            f"knobs=(k={kn['k']},s={kn['s']},b={kn['b']},q={kn['q']},"
            f"ga={kn['grad_accum']}) "
            f"ratios=E{rat['energy']:.2f}/C{rat['comm']:.2f}/"
            f"M{rat['memory']:.2f}/T{rat['temp']:.2f} "
            f"lam=({lam['energy']:.2f},{lam['comm']:.2f},"
            f"{lam['memory']:.2f},{lam['temp']:.2f}) "
            f"{r.seconds:.1f}s")
        if r.dropped:
            line += (f" part={len(r.participants)}/"
                     f"{len(r.participants) + len(r.dropped)}"
                     f" drop={len(r.dropped)}")
        if r.late_arrivals:
            line += (f" late={len(r.late_arrivals)}"
                     f" stale={r.mean_staleness:.2f}")
        if r.updates_applied != 1:   # not the plain one-barrier round
            line += f" upd={r.updates_applied}"
        if getattr(engine, "time_mode", "rounds") == "wall_clock":
            line += f" sim={r.sim_time:.2f}(+{r.round_seconds:.2f})"
        self.log(line)


class CheckpointCallback(RoundCallback):
    """Save engine params every ``every`` rounds (0 = final only) through
    ``repro_torch.checkpointing``."""

    def __init__(self, path: str, every: int = 0):
        self.path = path
        self.every = every

    def _save(self, engine) -> None:
        from repro_torch.checkpointing import save
        save(self.path, engine.params)

    def on_round_end(self, engine, record) -> None:
        if self.every and record.round % self.every == 0:
            self._save(engine)

    def on_train_end(self, engine, result) -> None:
        self._save(engine)


class HistoryWriterCallback(RoundCallback):
    """Dump the round-by-round history as JSON (the reference's format)."""

    def __init__(self, path: str):
        self.path = path

    def on_train_end(self, engine, result) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.path)) or ".",
                    exist_ok=True)
        payload = {
            "method": result.method,
            "summary": result.summary(),
            "history": [dataclasses.asdict(r) for r in result.history],
        }
        with open(self.path, "w") as f:
            json.dump(payload, f, indent=1)


class TimingCallback(RoundCallback):
    """Wall-clock per round and for the whole run."""

    def __init__(self):
        self.round_seconds: List[float] = []
        self.total_seconds: Optional[float] = None
        self._t0 = None

    def on_train_start(self, engine) -> None:
        self._t0 = time.time()

    def on_round_end(self, engine, record) -> None:
        self.round_seconds.append(record.seconds)

    def on_train_end(self, engine, result) -> None:
        if self._t0 is not None:
            self.total_seconds = time.time() - self._t0
