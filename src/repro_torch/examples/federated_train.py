"""CAFL-L vs FedAvg on a small federated char-LM (a scaled-down version of
the paper's experiment), driven through the composable engine API:
strategy x executor x callbacks.

    PYTHONPATH=src python -m repro_torch.examples.federated_train [--device cpu]
"""
from repro_torch.examples._common import parse, parser, rounds, small_fleet
from repro_torch.fl import FederatedEngine, LoggingCallback
from repro_torch.models import build


def main(argv=None):
    _, dev = parse(parser(__doc__), argv)
    ds, cfg, fl = small_fleet(rounds(6), clients_per_round=3)
    model = build(cfg)
    results = {}
    for method in ("fedavg", "cafl"):
        print(f"=== {method} ===")
        # "batched" stacks same-knob clients into one vmapped LocalTrain;
        # "sequential" runs them one by one.
        engine = FederatedEngine(model, fl, ds, strategy=method,
                                 executor="batched",
                                 callbacks=[LoggingCallback()], device=dev)
        results[method] = engine.run()

    print("\nsummary (tail means):")
    for name, res in results.items():
        s = res.summary(tail=3)
        print(f" {name:7s} E={s['energy']:.3g} C={s['comm_mb']:.3f}MB "
              f"M={s['memory']:.3f} T={s['temp']:.3f} "
              f"val={s['val_loss']:.3f}")
    print("\nCAFL-L keeps usage at/below budget while FedAvg violates comm "
          "and memory; see benchmarks/table1.py for the full-paper run, and "
          "repro_torch.examples.heterogeneous_fleet for per-device-class "
          "budgets.")
    return results


if __name__ == "__main__":
    main()
