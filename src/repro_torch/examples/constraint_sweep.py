"""Budget sweep: how the CAFL-L policy's operating point moves as each
budget is tightened (the control loop alone: the policy, the resource
proxies and the dual update; no network runs, so no tensor reaches the
device, which is still resolved as every entry point's is).

    PYTHONPATH=src python -m repro_torch.examples.constraint_sweep [--device cpu]
"""
import numpy as np

from repro_torch.configs import get_fl_config
from repro_torch.core.duals import DualState, dual_update, usage_ratios
from repro_torch.core.policy import policy
from repro_torch.core.resources import calibrate
from repro_torch.examples._common import parse, parser

P = 1.9e6


def steady_state(fl_cfg, res, rounds=150, tail=30):
    """Tail-averaged operating point (duals oscillate around thresholds)."""
    def p_active(k):
        return P * (0.94 * k / fl_cfg.k_base + 0.06)

    duals = DualState()
    kns, ratios = [], []
    for t in range(rounds):
        kn = policy(duals, fl_cfg)
        u = res.usage(p_active(kn.k), kn)
        duals = dual_update(duals, u, fl_cfg.budgets, fl_cfg.duals)
        if t >= rounds - tail:
            kns.append(kn)
            ratios.append(usage_ratios(u, fl_cfg.budgets))
    mean_r = {k: float(np.mean([r[k] for r in ratios])) for k in ratios[0]}
    mean_kn = {f: float(np.mean([getattr(k, f) for k in kns]))
               for f in ("k", "s", "b", "q", "grad_accum")}
    return mean_kn, mean_r


def main(argv=None):
    parse(parser(__doc__), argv)
    fl = get_fl_config()
    res = calibrate(P, fl)
    print(f"{'budget scale':>14s} | {'mean knobs (k,s,b,q,ga)':>28s} | "
          "mean ratios E/C/M/T")
    rows = {}
    for resource in ("comm", "energy", "memory"):
        for scale in (2.0, 1.0, 0.5, 0.25):
            budgets = fl.budgets.scaled(**{resource: scale})
            kn, r = rows[resource, scale] = steady_state(
                fl.replace(budgets=budgets), res)
            print(f"{resource}x{scale:<5g} | k={kn['k']:.1f} "
                  f"s={kn['s']:4.1f} b={kn['b']:4.1f} q={kn['q']:.1f} "
                  f"ga={kn['grad_accum']:4.1f} | "
                  f"{r['energy']:.2f}/{r['comm']:.2f}/{r['memory']:.2f}/"
                  f"{r['temp']:.2f}")
    print("\nTighter comm budgets push q (compression); tighter energy "
          "budgets cut s; the token budget (Eq. 8) raises grad_accum to "
          "compensate.")
    return rows


if __name__ == "__main__":
    main()
