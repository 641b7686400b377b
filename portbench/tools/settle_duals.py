"""Where CAFL-L's duals settle, from the proxies alone (no training).

Rolls the engine's loop of knobs -> proxy usage -> dead-zone dual step
forward from zero duals with the reference's arithmetic
(``portbench.reference.fl``) and the configuration's exact active
parameter counts, and prints the duals after ``--rounds`` rounds and
the knobs of the ``--show`` rounds that follow. The numbers go into the
federated traffic file's ``init_duals``, so that a run's rounds start
where the controller has settled. (At the paper's budgets the energy,
memory and temperature duals come to rest; the comm dual has no fixed
point, since q 1 is over its budget and q 2 under it by more than the
dead zone, so q alternates between 1 and 2 for good.)

    python3 -m portbench.tools.settle_duals [--rounds 300]
"""
import argparse
import json
import math
import os

from portbench.reference import fl as ref_fl, weights

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def settle(config, rounds: int, show: int):
    model, fl = config["model"], config["fl"]
    sizes = {}
    for leaf in weights.leaf_specs(model):
        n = math.prod(leaf.shape) * (model["num_layers"] if leaf.stacked
                                     else 1)
        sizes[leaf.name] = n
    res = ref_fl.proxies(sum(sizes.values()), fl)
    lam = {r: 0.0 for r in ref_fl.RESOURCES}
    hist = []
    for _ in range(rounds + show):
        kn = ref_fl.knobs(lam, fl)
        use = ref_fl.usage(res, ref_fl.active_params(sizes, kn["k"], model),
                           kn)
        hist.append((dict(lam), kn))
        lam = {r: ref_fl.dual_step(lam[r], use[r] / fl["budgets"][r],
                                   fl["duals"]) for r in ref_fl.RESOURCES}
    return hist[rounds][0], [h[1] for h in hist[rounds:]]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--show", type=int, default=12)
    ap.add_argument("--config", default="charlm-shakespeare")
    args = ap.parse_args()
    with open(os.path.join(HERE, "configs", args.config + ".json")) as f:
        config = json.load(f)
    lam, cycle = settle(config, args.rounds, args.show)
    print(json.dumps({"init_duals": lam, "knobs": cycle}, indent=1))


if __name__ == "__main__":
    main()
