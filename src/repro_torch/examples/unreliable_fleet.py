"""Unreliable fleet: CAFL-L under K-of-N sampling, churn and stragglers.

A two-tier fleet where low-end devices are reachable only ~60% of
rounds (Bernoulli churn), the server samples K of the available
clients, and a round deadline drops anything slower than 2x a baseline
round; the slow tier's 2.5x silicon plus log-normal jitter makes it the
usual victim. Dropped clients' token budgets carry to their next
participation as extra gradient accumulation, and the duals only ever
see the usage of clients that reported.

    PYTHONPATH=src python -m repro_torch.examples.unreliable_fleet [--device cpu]
"""
from repro_torch.examples._common import parse, parser, rounds, small_fleet
from repro_torch.fl import (BernoulliChurn, DeadlineStragglers,
                            FederatedEngine, FleetClass, FleetDynamics,
                            UniformSampler, make_fleet)
from repro_torch.models import build


def main(argv=None):
    _, dev = parse(parser(__doc__), argv)
    ds, cfg, fl = small_fleet(rounds(8), clients_per_round=4)
    profiles, client_profiles = make_fleet(fl, [
        FleetClass("highend", fraction=0.5, budget_scale=1.5),
        FleetClass("lowend", fraction=0.5, budget_scale=0.5,
                   compute_scale=2.5, availability=0.6),
    ])
    dynamics = FleetDynamics(
        sampler=UniformSampler(fl.clients_per_round),
        availability=BernoulliChurn(p=1.0),    # scaled by tier availability
        stragglers=DeadlineStragglers.for_config(fl, deadline=2.0,
                                                 jitter=0.35),
    )
    engine = FederatedEngine(build(cfg), fl, ds, strategy="cafl",
                             executor="batched", profiles=profiles,
                             client_profiles=client_profiles,
                             dynamics=dynamics, device=dev)
    res = engine.run()

    print(f"{'round':>5s} | {'avail':>5s} | {'reported':>16s} | "
          f"{'dropped':>10s} | val")
    for r in res.history:
        part = ",".join(str(c) for c in r.participants) or "-"
        drop = ",".join(str(c) for c in r.dropped) or "-"
        print(f"{r.round:5d} | {r.num_available:5d} | {part:>16s} | "
              f"{drop:>10s} | {r.val_loss:.4f}")
    n_drops = sum(len(r.dropped) for r in res.history)
    n_parts = sum(len(r.participants) for r in res.history)
    print(f"\n{n_parts} client-rounds reported, {n_drops} dropped at the "
          f"deadline; every dual update saw survivors only, and each "
          f"dropped client returned with its lost token budget re-credited "
          f"as extra grad-accum.")
    return res


if __name__ == "__main__":
    main()
