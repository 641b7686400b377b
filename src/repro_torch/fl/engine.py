"""The federated engine (Algorithm 1 as control flow), on one device.

``FederatedEngine`` wires the replaceable pieces of the reference's
engine: a strategy (knobs, delta combination, duals), a client executor
(sequential, or batched over same-knob clients), device profiles, fleet
dynamics (availability, sampling, stragglers), an aggregator (when
reports become server updates) and round callbacks. Every finished
client becomes a ``ClientReport`` fed to ``aggregator.submit``. With an
``accepts_late`` aggregator, clients that miss the deadline still train,
and their report is delivered later with ``staleness = delivery_round -
training_round``; only reports that can never land (no clock, a barrier
aggregator, past the horizon) feed the dropout ledger. At run end
``Aggregator.finalize`` drains a partial buffer. Constraint accounting
folds the reports in canonical order, so the duals are a function of
the report set.

Two time modes, as in the reference (``fl.clock``):

    "rounds"      the loop advances in abstract rounds; a late report
                  lands ``ceil(t / deadline) - 1`` rounds after its own
                  (``pending``), and the clock is accounting only
    "wall_clock"  a ``SimClock`` advances on events: a barrier round
                  lasts until its survivors reported (or the deadline),
                  a buffered-async round ends at its first mid-round
                  update, late reports land at their arrival time
                  (``EventQueue``), and ``horizon_seconds`` can replace
                  the round count

The engine runs on ``device`` (``None`` -> ``"cuda"``, which raises
without a card): parameters, client training, eval and the masked-sum
fold all live there. Once an update is applied, the engine drops its
reports' deltas (callbacks see them in ``on_server_update`` first), so
late reports hold device memory only while in flight.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.configs.base import FLConfig
from repro_torch.constraints import ConstraintSet, paper_constraints
from repro_torch.core import aggregation
from repro_torch.core.client import ClientRunner
from repro_torch.core.duals import DualState
from repro_torch.core.freezing import count_params
from repro_torch.core.resources import ResourceModel, calibrate
from repro_torch.core.server import FLResult, RoundRecord, make_eval_fn
from repro_torch.data.federated import FederatedData
from repro_torch.data.shakespeare import CharDataset
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl.aggregator import (Aggregator, ClientReport, ServerUpdate,
                                       canonical_order, make_aggregator)
from repro_torch.fl.callbacks import RoundCallback
from repro_torch.fl.clock import (TIME_MODES, EventQueue, RoundTimeModel,
                                  SimClock, make_round_time)
from repro_torch.fl.device import (DEFAULT_PROFILE, ClientInfo, DeviceProfile,
                                   uniform_fleet)
from repro_torch.fl.dynamics import FleetDynamics, RoundPlan
from repro_torch.fl.executor import ClientExecutor, make_executor
from repro_torch.fl.strategy import FederatedStrategy, make_strategy
from repro_torch.models.convert import as_params
from repro_torch.models.zoo import Model

ExecutorSpec = Union[str, Callable[[ClientRunner], ClientExecutor]]


class FederatedEngine:
    def __init__(self, model: Model, fl: FLConfig, dataset: CharDataset,
                 strategy: Union[str, FederatedStrategy, None] = None,
                 executor: Optional[ExecutorSpec] = None,
                 profiles: Optional[Dict[str, DeviceProfile]] = None,
                 client_profiles: Optional[Sequence[str]] = None,
                 dynamics: Optional[FleetDynamics] = None,
                 aggregator: Union[str, Aggregator, None] = None,
                 callbacks: Sequence[RoundCallback] = (),
                 resources: Optional[ResourceModel] = None,
                 init_duals: Optional[DualState] = None,
                 round_time: Union[str, RoundTimeModel, None] = None,
                 event_queue: Optional[Callable[[], EventQueue]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self.fl = fl
        self.dataset = dataset
        if strategy is None:
            strategy = fl.method
        self.strategy = (make_strategy(strategy, fl, init_duals=init_duals)
                         if isinstance(strategy, str) else strategy)
        self._executor_spec: ExecutorSpec = executor or fl.executor
        if profiles is None:
            profiles, client_profiles = uniform_fleet(fl)
        if client_profiles is None or len(client_profiles) != fl.num_clients:
            raise ValueError("client_profiles must name a profile for every "
                             "client")
        self._profiles_raw = profiles
        self._client_profiles = list(client_profiles)
        self.dynamics = dynamics or FleetDynamics.default(fl)
        self.aggregator = make_aggregator(aggregator or fl.aggregator, fl)
        self.callbacks = list(callbacks)
        self._base_resources = resources
        self.round_time = make_round_time(round_time, fl)
        # wall-clock event-queue factory (None: a plain EventQueue)
        self.event_queue_factory = event_queue
        self.data = FederatedData(dataset.train, fl.num_clients, seed=fl.seed,
                                  noniid_alpha=fl.noniid_alpha)
        self.params = None            # live during run(); callbacks read it
        self.profiles: Dict[str, DeviceProfile] = {}
        self.time_mode = fl.time_mode  # resolved per run()
        self.clock: Optional[SimClock] = None
        self._runner_cache = None     # (runner, executor)

    # ------------------------------------------------------------------
    def _setup(self, init_params):
        fl = self.fl
        if init_params is None:
            params = self.model.init(torch.Generator().manual_seed(fl.seed),
                                     self.device).params()
        else:
            params = {k: v.to(self.device)
                      for k, v in as_params(init_params).items()}
        # calibrate proxies at the baseline operating point (all layers
        # active) and specialize per device profile
        base = self._base_resources
        if base is None:
            base = calibrate(count_params(params), fl)
        self.profiles = {name: p.with_resources(base)
                         for name, p in self._profiles_raw.items()}
        if self._runner_cache is None:
            runner = ClientRunner(self.model, fl, self.data, base,
                                  device=self.device)
            executor = (make_executor(self._executor_spec, runner)
                        if isinstance(self._executor_spec, str)
                        else self._executor_spec(runner))
            self._runner_cache = (runner, executor)
        runner, executor = self._runner_cache
        return params, runner, executor

    def _client_info(self, cid: int) -> ClientInfo:
        profile = self.profiles[self._client_profiles[cid]]
        return ClientInfo(client_id=cid, profile=profile,
                          shard_size=self.data.shard_size(cid))

    def _emit(self, hook: str, *args) -> None:
        for cb in self.callbacks:
            getattr(cb, hook)(self, *args)

    def _report(self, ci: ClientInfo, kn, policy_kn, out, rnd: int,
                arrival: float) -> ClientReport:
        """Wrap one executor result as the server-side report; ``weight``
        is the client's example count."""
        usage = ci.profile.resources.usage(out.params_active, kn)
        energy = ci.profile.resources.usage(out.params_active, kn,
                                            include_accum=True)["energy"]
        return ClientReport(client=ci, delta=out.delta,
                            weight=float(ci.shard_size), knobs=kn,
                            policy_knobs=policy_kn, round_trained=rnd,
                            arrival_time=arrival,
                            train_loss=out.train_loss,
                            wire_mb_actual=out.wire_mb_actual,
                            params_active=out.params_active,
                            usage=usage, energy_true=energy)

    # ------------------------------------------------------------------
    def run(self, rounds: Optional[int] = None, init_params=None,
            time_mode: Optional[str] = None,
            horizon_seconds: Optional[float] = None) -> FLResult:
        """Run the federated loop from ``init_params`` (a ``ParamTree`` or
        parameter dict; default: fresh weights from ``fl.seed``).

        ``time_mode`` overrides ``fl.time_mode``. A ``horizon_seconds``
        budget (argument or ``fl.horizon_seconds``) implies wall-clock
        mode and replaces the round count (an explicit ``rounds`` still
        caps it); late reports that could only land past it are lost.
        An explicit ``time_mode="rounds"`` ignores the config's horizon,
        and an explicit horizon with a mode other than wall clock
        raises."""
        fl = self.fl
        if time_mode is None:
            if horizon_seconds is None:
                horizon_seconds = fl.horizon_seconds
            time_mode = ("wall_clock" if horizon_seconds is not None
                         else fl.time_mode)
        else:
            if horizon_seconds is None and time_mode == "wall_clock":
                horizon_seconds = fl.horizon_seconds
            if horizon_seconds is not None and time_mode != "wall_clock":
                raise ValueError(
                    f"horizon_seconds requires time_mode='wall_clock', "
                    f"got {time_mode!r}")
        if time_mode not in TIME_MODES:
            raise ValueError(f"unknown time_mode {time_mode!r}; "
                             f"options: {', '.join(TIME_MODES)}")
        wall = time_mode == "wall_clock"
        self.time_mode = time_mode
        explicit_rounds = rounds is not None
        rounds = rounds or fl.rounds
        # a horizon bounds the run in simulated seconds; the backstop
        # only stops a zero-length-round bug from spinning forever
        max_rounds = (rounds if horizon_seconds is None or explicit_rounds
                      else 100_000)
        rng = np.random.default_rng(fl.seed)
        params, runner, executor = self._setup(init_params)
        evaluate = make_eval_fn(self.model, self.dataset, fl,
                                device=self.device)
        result = FLResult(method=self.strategy.name)
        heterogeneous = len(self.profiles) > 1
        # what the server measures each round: the strategy's constraint
        # set when it carries one (CAFLL), else the paper's four proxies
        cset: ConstraintSet = (getattr(self.strategy, "constraints", None)
                               or paper_constraints())

        dynamics = self.dynamics
        dynamics.reset()
        self.strategy.reset()
        agg = self.aggregator
        agg.reset(self.strategy.aggregate)
        fleet = [self._client_info(c) for c in range(fl.num_clients)]
        clock = self.clock = SimClock()
        rtm = self.round_time
        server_cost = getattr(rtm, "server_seconds", 0.0)
        # in-flight late reports. rounds mode: delivery round -> reports
        # and client -> delivery round; wall clock: an arrival-time queue
        # and the busy set. A straggler is still training until its
        # report lands, so it is off the sampling roster meanwhile.
        pending: Dict[int, List[ClientReport]] = {}
        busy_until: Dict[int, int] = {}
        pending_q = (self.event_queue_factory()
                     if self.event_queue_factory is not None
                     else EventQueue())
        busy: set = set()

        self.params = params
        self._emit("on_train_start")
        t = 0
        while t < max_rounds:
            if wall and horizon_seconds is not None and result.history \
                    and clock.now >= horizon_seconds:
                break
            t += 1
            t0 = time.time()
            round_start = clock.now
            self._emit("on_round_start", t)
            # the round's own work (the hooks around it are the caller's)
            with telemetry.span("fl.round"):
                with telemetry.span("fl.eval"):
                    val_loss = evaluate(params)

                # --- round composition: gate, sample, deadline -------------
                if wall:
                    roster = ([ci for ci in fleet if ci.client_id not in busy]
                              if busy else fleet)
                else:
                    # sorted: expiry must not depend on delivery order
                    for cid in sorted(c for c, due in busy_until.items()
                                      if due < t):
                        del busy_until[cid]
                    roster = ([ci for ci in fleet
                               if ci.client_id not in busy_until]
                              if busy_until else fleet)
                avail, clients = dynamics.compose(
                    t, roster, rng, self.strategy.duals_snapshot())
                base_knobs = self.strategy.configure_round(t, clients)
                knobs = dynamics.adjust_knobs(clients, base_knobs)
                surv_idx, drop_idx, times = dynamics.finish(t, clients, knobs,
                                                            rng)
                # the deadline in force during this round (a knob policy may
                # move it in observe_round, for the next round)
                deadline = getattr(dynamics.stragglers, "deadline", None)
                # deadline-missers: late (the report still lands, if the
                # aggregator takes it and the run is still going) or lost
                late_idx: List[int] = []
                lost_idx: List[int] = []
                due_round: Dict[int, int] = {}
                if wall:
                    for i in drop_idx:
                        if agg.accepts_late and times and (
                                horizon_seconds is None
                                or round_start + times[i] <= horizon_seconds):
                            late_idx.append(i)
                        else:
                            lost_idx.append(i)
                else:
                    for i in drop_idx:
                        delay = (dynamics.stragglers.late_rounds(times[i])
                                 if agg.accepts_late and times else None)
                        if delay is not None and t + delay <= rounds:
                            late_idx.append(i)
                            due_round[i] = t + delay
                        else:
                            lost_idx.append(i)
                survivors = [clients[i] for i in surv_idx]
                plan = RoundPlan(
                    round=t,
                    available=tuple(ci.client_id for ci in avail),
                    sampled=tuple(ci.client_id for ci in clients),
                    survivors=tuple(ci.client_id for ci in survivors),
                    dropped=tuple(clients[i].client_id for i in drop_idx),
                    times=tuple(times),
                    late=tuple(clients[i].client_id for i in late_idx))
                self._emit("on_round_composed", plan)
                if lost_idx:
                    self.strategy.on_dropout([clients[i] for i in lost_idx])
                agg.begin_round(t, clients)

                # --- LocalTrain: survivors report now, late clients' reports
                # are queued for when their clock lands ---------------------
                exec_idx = list(surv_idx) + late_idx
                with telemetry.span("fl.localtrain"):
                    outs = (executor.run_round(
                        params, [(clients[i], knobs[i]) for i in exec_idx])
                        if exec_idx else [])
                reports = {
                    i: self._report(clients[i], knobs[i], base_knobs[i], o, t,
                                    times[i] if times else 0.0)
                    for i, o in zip(exec_idx, outs)}
                if not wall:
                    for i in late_idx:
                        pending.setdefault(due_round[i], []).append(reports[i])
                        busy_until[clients[i].client_id] = due_round[i]

                # --- deliver; the aggregator decides when reports become
                # server updates ---------------------------------------------
                base_dur = rtm.round_seconds(clients, knobs, times, surv_idx,
                                             deadline)
                if wall and base_dur <= 0.0:
                    raise ValueError(
                        f"{type(rtm).__name__}.round_seconds returned "
                        f"{base_dur!r}; wall-clock rounds need positive "
                        f"durations")
                applied: List[ServerUpdate] = []

                def _apply(update, params):
                    params = aggregation.apply_delta(params, update.delta)
                    self.params = params
                    applied.append(update)
                    self._emit("on_server_update", update)
                    _release(update)
                    return params

                if wall:
                    round_end_cap = round_start + base_dur
                    # earlier rounds' reports landing in this round's window,
                    # popped before this round's missers join the queue: a
                    # miss is always at least one round late
                    due = pending_q.pop_until(round_end_cap)
                    for i in late_idx:
                        pending_q.push(round_start + times[i], reports[i])
                        busy.add(clients[i].client_id)
                    events = [pending_q.stamp(
                        round_start + (times[i] if times
                                       else rtm.client_seconds(clients[i],
                                                               knobs[i])),
                        reports[i]) for i in surv_idx]
                    events = sorted(events + due, key=lambda e: e.sort_key())
                    arrived = []
                    inbox: List[ClientReport] = []
                    round_end = round_end_cap
                    cut = None
                    for k, ev in enumerate(events):
                        rep = ev.report
                        clock.advance_to(ev.arrival,
                                         f"deliver:c{rep.client.client_id}")
                        if rep.round_trained < t:
                            arrived.append(rep)
                        busy.discard(rep.client.client_id)
                        rep.round_submitted = t
                        rep.staleness = t - rep.round_trained
                        inbox.append(rep)
                        update = agg.submit(rep)
                        if update is not None:
                            params = _apply(update, params)
                            if agg.applies_mid_round:
                                # the buffer event ends this round; later
                                # deliveries belong to the next round
                                round_end = ev.arrival + server_cost
                                cut = k + 1
                                break
                    if cut is not None:
                        for ev in events[cut:]:
                            pending_q.push_event(ev)
                            busy.add(ev.report.client.client_id)
                    else:
                        update = agg.flush(t)
                        if update is not None:
                            params = _apply(update, params)
                    clock.advance_to(round_end, f"round_end:{t}")
                else:
                    arrived = sorted(pending.pop(t, ()),
                                     key=lambda r: (r.round_trained,
                                                    r.arrival_time))
                    inbox = arrived + [reports[i] for i in surv_idx]
                    for rep in inbox:
                        rep.round_submitted = t
                        rep.staleness = t - rep.round_trained
                        update = agg.submit(rep)
                        if update is not None:
                            params = _apply(update, params)
                    update = agg.flush(t)
                    if update is not None:
                        params = _apply(update, params)
                    # accounting only in rounds mode: the barrier's duration
                    clock.advance_to(round_start + base_dur, f"round_end:{t}")
                dynamics.settle(clients, base_knobs, knobs,
                                list(surv_idx) + late_idx, lost_idx)

                # --- constraint accounting over the reports delivered, in
                # canonical order (the float means are a function of the
                # report set); ``inbox`` keeps delivery order ---------------
                stats = canonical_order(inbox)
                usages = [cset.measure(rep) for rep in stats]
                if stats:
                    usage = {n: float(np.mean([u[n] for u in usages]))
                             for n in cset.names}
                    train_loss = float(np.mean([rep.train_loss
                                                for rep in stats]))
                    wire_mb = float(np.mean([rep.wire_mb_actual
                                             for rep in stats]))
                    energy = float(np.mean([rep.energy_true for rep in stats]))
                else:               # everyone dropped / nobody reachable
                    usage = cset.zero_usage()
                    train_loss = wire_mb = energy = 0.0
                ratios = cset.ratios(usage, fl.budgets)
                duals_by_profile = self.strategy.update_state(
                    usages, [rep.client for rep in stats])
                creports = self.strategy.constraint_reports()
                if creports:
                    self._emit("on_dual_update", t, creports)
                self.strategy.observe_round(plan, inbox, dynamics)

                if self.device.type == "cuda":
                    # the round's seconds cover its device work too
                    torch.cuda.synchronize(self.device)
            duals_rec = _default_duals(duals_by_profile, cset.names)
            record = RoundRecord(
                round=t, val_loss=val_loss,
                knobs=base_knobs[0].as_dict() if base_knobs else {},
                usage=usage, ratios=ratios,
                duals=duals_rec,
                constraints={n: {"ratio": ratios[n],
                                 "lam": duals_rec.get(n, 0.0),
                                 "violated": ratios[n] > 1.0}
                             for n in cset.names},
                train_loss=train_loss,
                wire_mb_actual=wire_mb,
                energy_true=energy,
                seconds=time.time() - t0,
                sim_time=clock.now,
                round_seconds=clock.now - round_start,
                per_profile=_per_profile_record(
                    [rep.client for rep in stats],
                    [rep.policy_knobs for rep in stats], usages,
                    duals_by_profile, cset)
                if heterogeneous and stats else {},
                participants=[rep.client.client_id for rep in inbox],
                dropped=[clients[i].client_id for i in lost_idx],
                num_available=len(avail),
                updates_applied=len(applied),
                reports_applied=sum(len(u.reports) for u in applied),
                mean_staleness=(float(np.mean([rep.staleness
                                               for rep in stats]))
                                if stats else 0.0),
                late_arrivals=[rep.client.client_id for rep in arrived])
            result.history.append(record)
            self._emit("on_round_end", record)

        # drain what the policy still buffers (FedBuff's partial buffer):
        # those clients trained and were accounted
        update = agg.finalize(t)
        if update is not None:
            params = aggregation.apply_delta(params, update.delta)
            self.params = params
            self._emit("on_server_update", update)
            _release(update)
            last = result.history[-1]
            last.updates_applied += 1
            last.reports_applied += len(update.reports)
        if wall and len(pending_q):
            # in-flight reports whose arrival fell in no round: the run
            # ended first, so they never reach the model
            leftovers = pending_q.drain()
            if result.history:
                last = result.history[-1]
                last.dropped = (list(last.dropped)
                                + [ev.report.client.client_id
                                   for ev in leftovers])
            self.strategy.on_dropout([ev.report.client for ev in leftovers])
            for ev in leftovers:
                ev.report.delta = None

        result.final_params = params
        result.history[-1].val_loss = evaluate(params)
        self._emit("on_train_end", result)
        return result


def _release(update: ServerUpdate) -> None:
    """Drop the deltas of an applied update's reports: their work is in
    the parameters now, and a report kept for its metadata (a callback,
    the round's inbox) must not hold device memory."""
    for rep in update.reports:
        rep.delta = None


def _default_duals(duals_by_profile: Dict[str, Dict[str, float]],
                   names) -> Dict[str, float]:
    """The record's scalar dual dict: the default profile's duals, the
    sole profile's, or zeros (fedavg keeps no duals)."""
    if DEFAULT_PROFILE in duals_by_profile:
        return dict(duals_by_profile[DEFAULT_PROFILE])
    if duals_by_profile:
        return dict(next(iter(duals_by_profile.values())))
    return {n: 0.0 for n in names}


def _per_profile_record(clients: List[ClientInfo], knobs, usages,
                        duals_by_profile,
                        cset: ConstraintSet) -> Dict[str, Dict]:
    """Per-device-profile round record: usage means grouped by profile
    over the (client, constraint) usage matrix."""
    profiles = {ci.profile.name: ci.profile for ci in clients}
    name_arr = np.asarray([ci.profile.name for ci in clients])
    usage_mat = np.asarray([[u[n] for n in cset.names] for u in usages],
                           dtype=np.float64)
    out: Dict[str, Dict] = {}
    for pname in sorted(profiles):
        mask = name_arr == pname
        mean = usage_mat[mask].mean(axis=0)
        usage = {n: float(v) for n, v in zip(cset.names, mean)}
        slot = {"clients": int(mask.sum()),
                "knobs": knobs[int(np.argmax(mask))].as_dict(),
                "usage": usage,
                "ratios": cset.ratios(usage, profiles[pname].budgets)}
        if pname in duals_by_profile:
            slot["duals"] = dict(duals_by_profile[pname])
        out[pname] = slot
    return out
