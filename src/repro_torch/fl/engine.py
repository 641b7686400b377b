"""The federated engine (Algorithm 1 as control flow), on one device.

``FederatedEngine`` wires the replaceable pieces of the reference's
engine: a strategy (knobs, delta combination, duals), a client executor,
device profiles, fleet dynamics, an aggregator (when reports become
server updates) and round callbacks. Every finished client becomes a
``ClientReport`` fed to ``aggregator.submit``; ``flush`` closes the
round's barrier. Constraint accounting folds the reports in canonical
order, so the duals are a function of the report set.

The engine runs on ``device`` (``None`` -> ``"cuda"``, which raises
without a card): parameters, client training, eval and the masked-sum
fold all live there. It runs the reference's ``time_mode="rounds"``,
where the virtual clock is accounting only; wall-clock mode, horizons
and aggregators that accept late reports are not ported yet (ROADMAP
queue 8).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

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
from repro_torch.fl.clock import RoundTimeModel, SimClock, make_round_time
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
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self.fl = fl
        self.dataset = dataset
        if strategy is None:
            strategy = fl.method
        self.strategy = (make_strategy(strategy, fl, init_duals=init_duals)
                         if isinstance(strategy, str) else strategy)
        self._executor_spec: ExecutorSpec = executor or "sequential"
        if profiles is None:
            profiles, client_profiles = uniform_fleet(fl)
        if client_profiles is None or len(client_profiles) != fl.num_clients:
            raise ValueError("client_profiles must name a profile for every "
                             "client")
        self._profiles_raw = profiles
        self._client_profiles = list(client_profiles)
        self.dynamics = dynamics or FleetDynamics.default(fl)
        self.aggregator = make_aggregator(aggregator or fl.aggregator, fl)
        if self.aggregator.accepts_late or self.aggregator.applies_mid_round:
            raise NotImplementedError(
                f"aggregator {self.aggregator.name!r} takes late or "
                f"mid-round reports; asynchronous delivery is not ported "
                f"yet (ROADMAP queue 8)")
        self.callbacks = list(callbacks)
        self._base_resources = resources
        self.round_time = make_round_time(round_time, fl)
        self.data = FederatedData(dataset.train, fl.num_clients, seed=fl.seed,
                                  noniid_alpha=fl.noniid_alpha)
        self.params = None            # live during run(); callbacks read it
        self.profiles: Dict[str, DeviceProfile] = {}
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
    def run(self, rounds: Optional[int] = None,
            init_params=None) -> FLResult:
        """Run the federated loop for ``rounds`` (default ``fl.rounds``)
        rounds from ``init_params`` (a ``ParamTree`` or parameter dict;
        default: fresh weights from ``fl.seed``)."""
        fl = self.fl
        rounds = rounds or fl.rounds
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

        self.params = params
        self._emit("on_train_start")
        t = 0
        for t in range(1, rounds + 1):
            t0 = time.time()
            round_start = clock.now
            self._emit("on_round_start", t)
            val_loss = evaluate(params)

            # --- round composition: gate, sample, deadline -------------
            avail, clients = dynamics.compose(
                t, fleet, rng, self.strategy.duals_snapshot())
            base_knobs = self.strategy.configure_round(t, clients)
            knobs = dynamics.adjust_knobs(clients, base_knobs)
            surv_idx, drop_idx, times = dynamics.finish(t, clients, knobs,
                                                        rng)
            deadline = getattr(dynamics.stragglers, "deadline", None)
            # no ported aggregator takes late reports: every miss is lost
            lost_idx = list(drop_idx)
            survivors = [clients[i] for i in surv_idx]
            plan = RoundPlan(
                round=t,
                available=tuple(ci.client_id for ci in avail),
                sampled=tuple(ci.client_id for ci in clients),
                survivors=tuple(ci.client_id for ci in survivors),
                dropped=tuple(clients[i].client_id for i in drop_idx),
                times=tuple(times))
            self._emit("on_round_composed", plan)
            if lost_idx:
                self.strategy.on_dropout([clients[i] for i in lost_idx])
            agg.begin_round(t, clients)

            # --- LocalTrain, then the barrier ---------------------------
            outs = (executor.run_round(
                params, [(clients[i], knobs[i]) for i in surv_idx])
                if surv_idx else [])
            inbox = [self._report(clients[i], knobs[i], base_knobs[i], o, t,
                                  times[i] if times else 0.0)
                     for i, o in zip(surv_idx, outs)]
            base_dur = rtm.round_seconds(clients, knobs, times, surv_idx,
                                         deadline)
            applied: List[ServerUpdate] = []

            def _apply(update, params):
                params = aggregation.apply_delta(params, update.delta)
                self.params = params
                applied.append(update)
                self._emit("on_server_update", update)
                return params

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
            dynamics.settle(clients, base_knobs, knobs, list(surv_idx),
                            lost_idx)

            # --- constraint accounting over the reports delivered, in
            # canonical order (the float means are a function of the
            # report set) ----------------------------------------------
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
                                if stats else 0.0))
            result.history.append(record)
            self._emit("on_round_end", record)

        update = agg.finalize(t)
        if update is not None:
            params = aggregation.apply_delta(params, update.delta)
            self.params = params
            self._emit("on_server_update", update)
            last = result.history[-1]
            last.updates_applied += 1
            last.reports_applied += len(update.reports)

        result.final_params = params
        result.history[-1].val_loss = evaluate(params)
        self._emit("on_train_end", result)
        return result


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
