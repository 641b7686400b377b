"""Heterogeneous fleet: CAFL-L with per-device-class budgets and duals.

Half the fleet is a high-end tier (1.5x budgets), half a low-end tier
(0.5x budgets, 1.5x energy/heat per token). The engine keeps one dual
state per tier, so the policy lands on a different operating point for
each device class.

    PYTHONPATH=src python -m repro_torch.examples.heterogeneous_fleet [--device cpu]
"""
from repro_torch.examples._common import parse, parser, rounds, small_fleet
from repro_torch.fl import FederatedEngine, FleetClass, make_fleet
from repro_torch.models import build


def main(argv=None):
    _, dev = parse(parser(__doc__), argv)
    ds, cfg, fl = small_fleet(rounds(8), clients_per_round=4)
    profiles, client_profiles = make_fleet(fl, [
        FleetClass("highend", fraction=0.5, budget_scale=1.5),
        FleetClass("lowend", fraction=0.5, budget_scale=0.5,
                   compute_scale=1.5),
    ])
    engine = FederatedEngine(build(cfg), fl, ds, strategy="cafl",
                             executor="batched", profiles=profiles,
                             client_profiles=client_profiles, device=dev)
    res = engine.run()

    print(f"{'round':>5s} | {'tier':>8s} | knobs (k,s,b,q,ga) | "
          "ratios E/C/M/T")
    for r in res.history:
        for name, slot in sorted(r.per_profile.items()):
            kn, rat = slot["knobs"], slot["ratios"]
            print(f"{r.round:5d} | {name:>8s} | "
                  f"({kn['k']},{kn['s']:2d},{kn['b']:2d},{kn['q']},"
                  f"{kn['grad_accum']}) | "
                  f"{rat['energy']:.2f}/{rat['comm']:.2f}/"
                  f"{rat['memory']:.2f}/{rat['temp']:.2f}")
    print("\nThe low-end tier's duals bite first: its policy freezes more "
          "layers, cuts local steps, and engages compression while the "
          "high-end tier keeps training near the baseline operating point.")
    return res


if __name__ == "__main__":
    main()
