"""Async fleet: FedBuff buffered aggregation against the deadline-discard
barrier, in rounds and in simulated seconds.

Half the fleet runs 2x slower silicon than the 1.1x round deadline
allows, so under the synchronous barrier its work is discarded every
round and its token budget carried as debt. A FedBuff aggregator lets
the deadline-missers' reports arrive in the round their simulated wall
clock lands in and folds them into the next buffered update with a
staleness discount. The second half re-runs both policies under
``time_mode="wall_clock"`` (``fl.clock``), where a discard round costs
one full deadline and a FedBuff round ends at its buffer-fill event.

    PYTHONPATH=src python -m repro_torch.examples.async_fleet [--device cpu]

(REPRO_EXAMPLE_ROUNDS caps the round budget for CI smoke runs.)
"""
from repro_torch.examples._common import parse, parser, rounds, small_fleet
from repro_torch.fl import (DeadlineStragglers, FedBuffAggregator,
                            FederatedEngine, FleetClass, FleetDynamics,
                            UniformSampler, make_fleet, seconds_to_target)
from repro_torch.models import build


def rounds_to(res, target):
    for r in res.history:
        if r.val_loss <= target:
            return r.round
    return None


def main(argv=None):
    _, dev = parse(parser(__doc__), argv)
    n_rounds = rounds(10)
    ds, cfg, fl = small_fleet(n_rounds, clients_per_round=4)
    # two tiers: the slow half's 2x silicon never makes the 1.1x deadline
    profiles, client_profiles = make_fleet(fl, [
        FleetClass("fast", fraction=0.5),
        FleetClass("slow", fraction=0.5, compute_scale=2.0),
    ])
    model = build(cfg)

    def engine(agg):
        return FederatedEngine(
            model, fl, ds, strategy="fedavg", executor="batched",
            profiles=profiles, client_profiles=client_profiles,
            dynamics=FleetDynamics(
                sampler=UniformSampler(fl.clients_per_round),
                stragglers=DeadlineStragglers.for_config(fl, deadline=1.1,
                                                         jitter=0.2)),
            aggregator=agg, device=dev)

    results = {}
    for name, agg in (("sync", "sync"),
                      ("fedbuff", FedBuffAggregator(buffer_size=3))):
        print(f"=== {name} ===")
        res = results[name] = engine(agg).run()
        used = sum(r.reports_applied for r in res.history)
        lost = sum(len(r.dropped) for r in res.history)
        late = sum(len(r.late_arrivals) for r in res.history)
        for r in res.history:
            print(f"  round {r.round:2d} val={r.val_loss:.4f} "
                  f"applied={r.reports_applied} late={len(r.late_arrivals)} "
                  f"lost={len(r.dropped)} stale={r.mean_staleness:.2f}")
        print(f"  client-rounds: {used} applied ({late} of them late), "
              f"{lost} discarded")

    # target: just below where the discard baseline ends up
    target = 0.99 * results["sync"].history[-1].val_loss
    print(f"\nrounds to reach 99% of the sync run's final loss "
          f"({target:.4f}):")
    for name, res in results.items():
        hit = rounds_to(res, target)
        print(f"  {name:8s} "
              f"{hit if hit is not None else f'>{n_rounds} (never)'}")
    buff_hit = rounds_to(results["fedbuff"], target)
    sync_hit = rounds_to(results["sync"], target)
    if buff_hit is not None and (sync_hit is None or buff_hit < sync_hit):
        print("\nFedBuff got there first: the slow tier's late reports were "
              "applied (staleness-discounted) instead of thrown away at the "
              "barrier.")

    # the same comparison on the virtual wall clock
    print("\n=== wall clock (simulated seconds; 1.0 = one baseline round) ===")
    wall = {}
    for name, agg in (("sync", "sync"),
                      ("fedbuff", FedBuffAggregator(buffer_size=3))):
        res = wall[name] = engine(agg).run(time_mode="wall_clock")
        total = res.history[-1].sim_time
        print(f"  {name:8s} {len(res.history)} rounds in {total:.2f} "
              f"simulated seconds ({total / len(res.history):.2f}/round), "
              f"final val={res.history[-1].val_loss:.4f}")
    wall_target = 0.99 * wall["sync"].history[-1].val_loss
    print(f"\nsimulated seconds to reach 99% of the discard baseline's final "
          f"loss ({wall_target:.4f}):")
    for name, res in wall.items():
        hit = seconds_to_target(res, wall_target)
        when = f"{hit:.2f}s" if hit is not None else "never (budget spent)"
        print(f"  {name:8s} {when}")
    return results, wall


if __name__ == "__main__":
    main()
