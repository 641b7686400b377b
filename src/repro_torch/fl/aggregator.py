"""Server-update policies: *when* client reports become server updates.

The engine turns every finished client into a ``ClientReport`` and feeds
it to an ``Aggregator``, which decides when reports are combined into
``ServerUpdate``s (``submit`` per arrival, ``flush`` at the round
barrier, ``finalize`` at run end). The policies, as in the reference:

    SyncAggregator        the paper's barrier (the default)
    FedBuffAggregator     buffered async: apply every ``buffer_size``
                          arrivals, mid-round, with staleness-discounted
                          deltas; deadline-missers deliver late
    StalenessWeighted-    the barrier, with late reports folded into a
    Aggregator            later round under a ``StalenessPolicy``
                          discount
    MaskedSumAggregator   pairwise-mask secure aggregation

Every policy folds its buffered reports in canonical report order
(``(round_trained, arrival_time, client_id)``), so the applied update is
a function of the report set, never of delivery order. Each class
declares how through ``commutativity``, the certificate
``repro_torch.analysis.sched`` checks (as the reference's):

    "exact"      order-free by construction (the uint64 masked sum is
                 associative and commutative mod 2^64)
    "canonical"  floats folded in canonical order (sync, staleness)
    "tiebreak"   the buffer's composition depends on delivery order
                 (FedBuff fills every K arrivals), which the engine makes
                 deterministic through ``TimedReport.sort_key``; each
                 fill folds in canonical order

A discount is
applied on the deltas' device, as a 0-d fp32 tensor (the reference's
weak-typed scalar).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.policy import Knobs
from repro_torch.fl.device import ClientInfo
from repro_torch.kernels import ops
from repro_torch.models.convert import jax_order

Combine = Callable[[Sequence, Optional[List[float]]], Any]


def report_order_key(report: "ClientReport") -> Tuple[int, float, int]:
    """The canonical total order over client reports: params version,
    then simulated arrival, then client id."""
    return (report.round_trained, report.arrival_time,
            report.client.client_id)


def canonical_order(reports: Sequence["ClientReport"]
                    ) -> List["ClientReport"]:
    """Reports sorted by ``report_order_key``."""
    return sorted(reports, key=report_order_key)


@dataclass
class ClientReport:
    """One finished LocalTrain, as the server receives it. ``weight`` is
    the client's example count (shard size); ``staleness`` is
    ``round_submitted - round_trained``."""
    client: ClientInfo
    delta: Any                    # masked, wire-compressed update dict
    weight: float                 # client example count (|D_i|)
    knobs: Knobs                  # knobs actually trained (incl. carry boost)
    policy_knobs: Knobs           # the strategy's policy knobs (no boost)
    round_trained: int            # params version the delta was computed on
    arrival_time: float = 0.0     # straggler wall-clock draw (0 if untimed)
    round_submitted: int = -1     # set when the server takes delivery
    staleness: int = 0            # round_submitted - round_trained
    train_loss: float = 0.0
    wire_mb_actual: float = 0.0
    params_active: float = 0.0
    usage: Dict[str, float] = field(default_factory=dict)
    energy_true: float = 0.0


@dataclass(frozen=True)
class ServerUpdate:
    """One application of client work to the server params."""
    delta: Any                          # dict to add to params
    reports: Tuple[ClientReport, ...]   # the reports folded in
    round: int                          # server round it was applied
    mean_staleness: float = 0.0


class StalenessPolicy:
    """Maps a report's staleness (rounds late) to a discount in (0, 1],
    non-increasing in staleness and 1.0 at 0."""

    name = "base"

    def discount(self, staleness: int) -> float:
        raise NotImplementedError


class PolynomialStaleness(StalenessPolicy):
    """FedBuff's s(tau) = (1 + tau)^(-alpha); alpha = 0 disables."""

    name = "polynomial"

    def __init__(self, alpha: float = 0.5):
        if alpha < 0.0:
            raise ValueError(f"alpha must be >= 0, got {alpha}")
        self.alpha = alpha

    def discount(self, staleness: int) -> float:
        if staleness < 0:
            raise ValueError(f"negative staleness {staleness}")
        return float((1.0 + staleness) ** (-self.alpha))


class ConstantStaleness(StalenessPolicy):
    """Fresh reports count fully; any late report a constant factor."""

    name = "constant"

    def __init__(self, factor: float = 0.5):
        if not 0.0 < factor <= 1.0:
            raise ValueError(f"factor must be in (0, 1], got {factor}")
        self.factor = factor

    def discount(self, staleness: int) -> float:
        if staleness < 0:
            raise ValueError(f"negative staleness {staleness}")
        return 1.0 if staleness == 0 else self.factor


def make_staleness_policy(spec) -> StalenessPolicy:
    if isinstance(spec, StalenessPolicy):
        return spec
    name = spec.lower()
    if name in ("polynomial", "poly"):
        return PolynomialStaleness()
    if name == "constant":
        return ConstantStaleness()
    if name == "none":
        return PolynomialStaleness(alpha=0.0)
    raise ValueError(f"unknown staleness policy {spec!r}; "
                     f"options: polynomial, constant, none")


def _scale_delta(delta: Dict[str, torch.Tensor], factor: float
                 ) -> Dict[str, torch.Tensor]:
    """``delta * factor`` in fp32 on the delta's device (the factor as a
    0-d fp32 tensor); a factor of 1 returns the delta itself."""
    if factor == 1.0:
        return delta
    out = {}
    for name, leaf in delta.items():
        f = torch.tensor(np.float32(factor), device=leaf.device)
        out[name] = leaf.to(torch.float32) * f
    return out


class Aggregator:
    """Server-update policy; the engine drives one instance per run:
    ``reset(combine)``, then per round ``begin_round(rnd, cohort)``,
    ``submit(report)`` per arrival and ``flush(rnd)`` at the barrier,
    and ``finalize(rnd)`` once at run end.

    ``accepts_late`` tells the engine to execute deadline-missers and
    deliver their reports when their simulated clock lands;
    ``applies_mid_round`` marks a policy whose ``submit`` can emit an
    update before the barrier (in wall-clock mode that update ends the
    round). ``commutativity`` is the policy's certificate under
    report-order permutation (the module docstring); a policy that
    declares none is flagged as a schedule race."""

    name = "base"
    accepts_late = False
    applies_mid_round = False
    commutativity: Optional[str] = None

    def __init__(self):
        self._combine: Optional[Combine] = None
        self._applied = 0

    def reset(self, combine: Combine) -> None:
        self._combine = combine
        self._applied = 0

    def begin_round(self, rnd: int, cohort: Sequence[ClientInfo]) -> None:
        pass

    def submit(self, report: ClientReport) -> Optional[ServerUpdate]:
        raise NotImplementedError

    def flush(self, rnd: int) -> Optional[ServerUpdate]:
        return None

    def finalize(self, rnd: int) -> Optional[ServerUpdate]:
        """Training is over: drain whatever the policy still buffers
        (nothing, for a barrier policy)."""
        return None

    def state_snapshot(self) -> Dict[str, Any]:
        return {"name": self.name, "updates_applied": self._applied}

    def _emit(self, rnd: int, reports: Sequence[ClientReport],
              delta) -> ServerUpdate:
        self._applied += 1
        reports = canonical_order(reports)
        stale = (float(np.mean([r.staleness for r in reports]))
                 if reports else 0.0)
        return ServerUpdate(delta=delta, reports=tuple(reports), round=rnd,
                            mean_staleness=stale)


class SyncAggregator(Aggregator):
    """The paper's round barrier: buffer every report of the round and
    apply one combined update at ``flush``. The default."""

    name = "sync"
    commutativity = "canonical"

    def __init__(self):
        super().__init__()
        self._buf: List[ClientReport] = []

    def reset(self, combine):
        super().reset(combine)
        self._buf = []

    def submit(self, report):
        self._buf.append(report)
        return None

    def flush(self, rnd):
        if not self._buf:
            return None
        reports, self._buf = self._buf, []
        reports = canonical_order(reports)
        delta = self._combine([r.delta for r in reports],
                              [r.weight for r in reports])
        return self._emit(rnd, reports, delta)

    def state_snapshot(self):
        return {**super().state_snapshot(), "buffered": len(self._buf)}


class StalenessWeightedAggregator(Aggregator):
    """The barrier, minus the discard: deadline-missers deliver in the
    round their clock lands in and fold into that round's update under a
    ``StalenessPolicy`` discount. ``mode="scale"`` multiplies the late
    delta by the discount (works under any combine); ``mode="weight"``
    multiplies its example-count weight (bites only with weighted
    combines)."""

    name = "staleness"
    commutativity = "canonical"
    accepts_late = True

    def __init__(self, policy: Optional[StalenessPolicy] = None,
                 mode: str = "scale"):
        super().__init__()
        if mode not in ("scale", "weight"):
            raise ValueError(f"mode must be 'scale' or 'weight', got "
                             f"{mode!r}")
        self.policy = policy or PolynomialStaleness()
        self.mode = mode
        self._buf: List[ClientReport] = []

    def reset(self, combine):
        super().reset(combine)
        self._buf = []

    def submit(self, report):
        self._buf.append(report)
        return None

    def flush(self, rnd):
        if not self._buf:
            return None
        reports, self._buf = self._buf, []
        reports = canonical_order(reports)
        discounts = [self.policy.discount(r.staleness) for r in reports]
        if self.mode == "scale":
            deltas = [_scale_delta(r.delta, d)
                      for r, d in zip(reports, discounts)]
            weights = [r.weight for r in reports]
        else:
            deltas = [r.delta for r in reports]
            weights = [r.weight * d for r, d in zip(reports, discounts)]
        return self._emit(rnd, reports, self._combine(deltas, weights))

    def state_snapshot(self):
        return {**super().state_snapshot(), "buffered": len(self._buf),
                "policy": self.policy.name, "mode": self.mode}


class FedBuffAggregator(Aggregator):
    """Buffered asynchronous aggregation (FedBuff): once ``buffer_size``
    reports have arrived the server applies their combined,
    staleness-discounted update at once, mid-round. The buffer persists
    across rounds (``flush`` does nothing); ``finalize`` applies a
    partial buffer at run end. Staleness is measured when the buffer is
    applied, so a report that waited in it keeps ageing."""

    name = "fedbuff"
    commutativity = "tiebreak"
    accepts_late = True
    applies_mid_round = True

    def __init__(self, buffer_size: int = 4,
                 policy: Optional[StalenessPolicy] = None):
        super().__init__()
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        self.buffer_size = buffer_size
        self.policy = policy or PolynomialStaleness()
        self._buf: List[ClientReport] = []

    def reset(self, combine):
        super().reset(combine)
        self._buf = []

    def submit(self, report):
        self._buf.append(report)
        if len(self._buf) < self.buffer_size:
            return None
        return self._apply_buffer(report.round_submitted)

    def finalize(self, rnd):
        if not self._buf:
            return None
        return self._apply_buffer(rnd)

    def _apply_buffer(self, rnd):
        reports, self._buf = self._buf, []
        reports = canonical_order(reports)
        for r in reports:
            r.staleness = max(r.staleness, rnd - r.round_trained)
        deltas = [_scale_delta(r.delta, self.policy.discount(r.staleness))
                  for r in reports]
        delta = self._combine(deltas, [r.weight for r in reports])
        return self._emit(rnd, reports, delta)

    def state_snapshot(self):
        return {**super().state_snapshot(), "buffered": len(self._buf),
                "buffer_size": self.buffer_size, "policy": self.policy.name}


class MaskedSumAggregator(Aggregator):
    """Pairwise-mask secure-aggregation simulation (Bonawitz et al.).

    Each sampled client's weighted delta is rounded to a fixed-point grid
    (``scale_bits`` fractional bits) on the host, as
    ``rint(float64(leaf) * weight * scale)``, and blinded with one
    pairwise mask per cohort partner: client ``min(i,j)`` adds ``m_ij``,
    ``max(i,j)`` subtracts it, mod 2^64. Each pair's masks come from
    ``default_rng([seed, round, lo, hi])``, one draw per leaf in JAX's
    leaf order, so the masked vectors equal the reference's bit for bit.
    A dropped client's masks are reconstructed and removed at ``flush``,
    so the unmasked total is the plain fixed-point sum of the reporters
    under every dropout pattern. The mean, ``int64 -> float64 /
    (scale * total weight) -> float32``, comes back as tensors on the
    device the deltas live on and flows through the strategy's combine as
    one delta.

    The masked vectors are buffered and the stacked cohort folds through
    ``ops.masked_sum_u64`` at flush, on the deltas' device: the
    masked-sum kernel on a card, its plain version on the CPU. (The
    reference's ``path="numpy"`` per-arrival accumulation is its oracle,
    not a path of the port; modular sums are associative, so the two
    give the same bits.)
    """

    name = "masked"
    commutativity = "exact"

    def __init__(self, scale_bits: int = 32, use_weights: bool = False,
                 seed: int = 0):
        super().__init__()
        if not 1 <= scale_bits <= 52:
            raise ValueError(f"scale_bits must be in 1..52, got {scale_bits}")
        self.scale = float(2 ** scale_bits)
        self.use_weights = use_weights
        self.seed = seed
        self._round = 0
        self._cohort: List[int] = []
        self._reporters: List[ClientReport] = []
        self._pending: List[List[np.ndarray]] = []
        self._layout: Optional[Tuple[List[str], torch.device]] = None
        self._reconstructed = 0

    def reset(self, combine):
        super().reset(combine)
        self._cohort, self._reporters, self._pending = [], [], []
        self._reconstructed = 0

    def begin_round(self, rnd, cohort):
        self._round = rnd
        self._cohort = [ci.client_id for ci in cohort]
        self._reporters = []
        self._pending = []
        self._layout = None

    # -- fixed-point + masks -------------------------------------------------
    def _weight(self, report: ClientReport) -> float:
        return report.weight if self.use_weights else 1.0

    def _quantize(self, delta: Dict[str, torch.Tensor], weight: float):
        """-> (per-leaf uint64 arrays in JAX's leaf order, (names,
        device))."""
        delta = jax_order(delta)
        names = list(delta)
        device = next(iter(delta.values())).device
        # np.int64 casts of out-of-range floats are silent garbage: each
        # weighted value must leave room for the whole cohort's sum
        limit = 2.0 ** 62 / max(1, len(self._cohort))
        q = []
        for name in names:
            leaf = delta[name].detach().cpu().numpy()
            vals = np.rint(np.asarray(leaf, np.float64) * weight * self.scale)
            if not np.all(np.abs(vals) < limit):
                raise OverflowError(
                    f"masked-sum fixed point overflow in {name}: |delta * "
                    f"weight| * 2^scale_bits exceeds int64 headroom "
                    f"({self.scale:g} * weight {weight:g}); lower scale_bits "
                    f"or the weights")
            q.append(vals.astype(np.int64).view(np.uint64))
        return q, (names, device)

    def _pair_masks(self, a: int, b: int,
                    like: List[np.ndarray]) -> List[np.ndarray]:
        lo, hi = (a, b) if a < b else (b, a)
        rng = np.random.default_rng([self.seed, self._round, lo, hi])
        return [rng.integers(0, 2 ** 64, size=l.shape, dtype=np.uint64)
                for l in like]

    def _add_masks(self, vec: List[np.ndarray], me: int, partner: int,
                   sign: int) -> List[np.ndarray]:
        masks = self._pair_masks(me, partner, vec)
        flip = 1 if me < partner else -1
        if sign * flip > 0:
            return [v + m for v, m in zip(vec, masks)]
        return [v - m for v, m in zip(vec, masks)]

    # -- protocol ------------------------------------------------------------
    def submit(self, report):
        me = report.client.client_id
        if me not in self._cohort:
            raise ValueError(f"client {me} is outside this round's cohort: "
                             f"masked sums need the cohort fixed before "
                             f"reports arrive")
        vec, self._layout = self._quantize(report.delta, self._weight(report))
        for partner in self._cohort:
            if partner != me:
                vec = self._add_masks(vec, me, partner, sign=+1)
        # the cohort folds in one pass at flush
        self._pending.append(vec)
        self._reporters.append(report)
        return None

    def _fold(self, device: torch.device) -> List[np.ndarray]:
        """Fold the buffered cohort mod 2^64 on ``device``."""
        shapes = [v.shape for v in self._pending[0]]
        sizes = [v.size for v in self._pending[0]]
        stacked = np.stack([np.concatenate([l.reshape(-1) for l in vec])
                            for vec in self._pending])
        tot = ops.masked_sum_u64(stacked, device=device)
        out, off = [], 0
        for shape, size in zip(shapes, sizes):
            out.append(tot[off:off + size].reshape(shape))
            off += size
        return out

    def flush(self, rnd):
        if not self._reporters:
            return None
        names, device = self._layout
        total = self._fold(device)
        reported = {r.client.client_id for r in self._reporters}
        for dropped in (c for c in self._cohort if c not in reported):
            # mask recovery: remove the masks reporters shared with the
            # dropped client (the live pairs already cancelled in-sum)
            for alive in sorted(reported):
                total = self._add_masks(total, alive, dropped, sign=-1)
                self._reconstructed += 1
        reports = canonical_order(self._reporters)
        tot_w = sum(self._weight(r) for r in reports)
        mean = {name: torch.from_numpy(
            (x.view(np.int64).astype(np.float64)
             / (self.scale * tot_w)).astype(np.float32)).to(device)
            for name, x in zip(names, total)}
        self._reporters, self._pending = [], []
        return self._emit(rnd, reports, self._combine([mean], [1.0]))

    def state_snapshot(self):
        return {**super().state_snapshot(), "cohort": len(self._cohort),
                "pending": len(self._reporters),
                "masks_reconstructed": self._reconstructed}


AGGREGATORS = ("sync", "fedbuff", "staleness", "masked")


def make_aggregator(spec, fl=None, **kw) -> Aggregator:
    """Resolve an aggregator spec: an instance passes through; strings
    name a policy ("sync", "fedbuff", "staleness", "masked"). ``fl``
    sizes FedBuff's default buffer at half the sampled cohort."""
    if isinstance(spec, Aggregator):
        return spec
    name = spec.lower()
    if name == "sync":
        return SyncAggregator(**kw)
    if name == "fedbuff":
        if "buffer_size" not in kw and fl is not None:
            kw["buffer_size"] = max(2, (fl.clients_per_round + 1) // 2)
        return FedBuffAggregator(**kw)
    if name in ("staleness", "staleness_weighted"):
        return StalenessWeightedAggregator(**kw)
    if name in ("masked", "masked_sum", "secagg"):
        return MaskedSumAggregator(**kw)
    raise ValueError(f"unknown aggregator {spec!r}; "
                     f"options: {', '.join(AGGREGATORS)}")
