"""CAFL-L's federated round, worked out again from the run's inputs.

What the program derives, the reference derives here from the same
seed, corpus, weights and starting duals: the knobs (the paper's Eq.
5-7 and Eq. 8), the clients a round samples (uniform K of N without
replacement), each client's shard and batches (per-client NumPy
streams), its LocalTrain (``s`` masked AdamW steps of ``grad_accum``
microbatches), the wire round trip at the round's ``q``, the plain mean
over the cohort, the proxies' usage (Appendix A.1, calibrated to Table
1's FedAvg row) and the dead-zone dual step (Eq. 4). ``follow`` runs
``rounds`` rounds and returns what each produced; it can first step
over rounds without training them, to follow a later round from the
parameters at its start.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import charlm
from portbench.reference.corpus import sample_batch

TABLE1_FEDAVG = {"energy": 4.52e6, "comm": 5.18, "temp": 0.62,
                 "memory": 0.31}
BYTES_PER_PARAM = {0: 4.0, 1: 1.0, 2: 0.25}
RESOURCES = ("energy", "comm", "memory", "temp")
Q_THRESHOLDS = (0.25, 1.0)


def knobs(lam: Dict[str, float], fl: Dict) -> Dict[str, int]:
    d = fl["duals"]
    le, lc, lm, lt = (lam.get(r, 0.0) for r in RESOURCES)
    k = max(d["k_min"], fl["k_base"]
            - math.floor(d["alpha_k"] * (lc + lm + 0.5 * lt)))
    s = max(d["s_min"], math.floor(fl["s_base"] * (1 - d["beta_s"]
                                                   * (le + lt))))
    b = max(d["b_min"], math.floor(fl["b_base"]
                                   / (1 + d["gamma_b"] * (lt + lm))))
    q = 2 if lc > Q_THRESHOLDS[1] else 1 if lc > Q_THRESHOLDS[0] else 0
    ga = max(1, math.ceil(fl["s_base"] * fl["b_base"] / (s * b)))
    return {"k": k, "s": s, "b": b, "q": q, "grad_accum": ga}


def proxies(p_total: float, fl: Dict) -> Dict[str, float]:
    s, b, p = fl["s_base"], fl["b_base"], float(p_total)
    rem = TABLE1_FEDAVG["temp"] - 0.35
    return {"alpha_e": TABLE1_FEDAVG["energy"] / (p * s * b),
            "kappa_c": TABLE1_FEDAVG["comm"] / (p * BYTES_PER_PARAM[0]),
            "beta_m": (TABLE1_FEDAVG["memory"] - 0.2) / (p * b),
            "gamma_t": (rem / 2) / s, "delta_t": (rem / 2) / b}


def usage(res: Dict[str, float], active: float, kn: Dict) -> Dict[str, float]:
    return {"energy": res["alpha_e"] * active * kn["s"] * kn["b"],
            "comm": 1.0 * active * BYTES_PER_PARAM[kn["q"]] * res["kappa_c"],
            "memory": 1.0 * (0.2 + res["beta_m"] * active * kn["b"]),
            "temp": 1.0 * (0.35 + res["gamma_t"] * kn["s"]
                           + res["delta_t"] * kn["b"])}


def dual_step(lam: float, ratio: float, d: Dict) -> float:
    x = ratio - 1.0
    dz = 0.0 if abs(x) <= d["deadzone"] else x
    return float(min(max(lam + d["eta"] * dz, 0.0), d["lambda_max"]))


def active_params(sizes: Dict[str, int], k: int, cfg: Dict) -> float:
    total = 0.0
    for name, n in sizes.items():
        m = charlm.trainable(name, k, cfg).numpy()
        total += (float(np.mean(m)) if m.ndim else float(m)) * n
    return total


def shards(train: np.ndarray, n: int) -> List[np.ndarray]:
    sizes = np.full(n, len(train) // n)
    sizes[-1] += len(train) - sizes.sum()
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    return [train[bounds[i]:bounds[i + 1]] for i in range(n)]


def _stack(params, c):
    return {k: v.unsqueeze(0).expand(c, *v.shape).clone()
            for k, v in params.items()}


def local_train(params, clients, streams, data, kn, model: Dict, fl: Dict,
                half_batch: bool = False):
    """LocalTrain of the cohort ``clients`` (all on the same knobs) from
    the round-global ``params`` -> (each client's update after the wire
    round trip and the mask (C, ...), each client's mean loss (C,))."""
    dev = next(iter(params.values())).device
    c, seq = len(clients), fl["seq_len"]
    n = kn["s"] * kn["grad_accum"]
    toks = np.empty((c, n, kn["b"], seq), np.int32)
    targ = np.empty_like(toks)
    for i, cid in enumerate(clients):
        for j in range(n):
            toks[i, j], targ[i, j] = sample_batch(data[cid], streams[cid],
                                                  kn["b"], seq)
    if half_batch:
        toks, targ = toks[:, :, :kn["b"] // 2], targ[:, :, :kn["b"] // 2]
    toks = torch.from_numpy(toks).to(dev)
    targ = torch.from_numpy(targ).to(dev)
    mask = {k: charlm.trainable(k, kn["k"], model) for k in params}
    w = _stack(params, c)
    state = {"mu": {k: torch.zeros_like(v) for k, v in w.items()},
             "nu": {k: torch.zeros_like(v) for k, v in w.items()},
             "count": 0}
    loss_sum = torch.zeros(c, dtype=torch.float64, device=dev)
    for step in range(kn["s"]):
        gsum = None
        for a in range(kn["grad_accum"]):
            j = step * kn["grad_accum"] + a
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in w.items()}
            with torch.enable_grad():
                per_client = charlm.losses(leaves, toks[:, j], targ[:, j],
                                           model)
                grads = torch.autograd.grad(per_client.sum(),
                                            list(leaves.values()))
            loss_sum += per_client.detach().double()
            grads = dict(zip(leaves, grads))
            gsum = grads if gsum is None else {
                k: gsum[k] + grads[k] for k in grads}
        gsum = {k: g / kn["grad_accum"] for k, g in gsum.items()}
        with torch.no_grad():
            w = charlm.adamw_step(w, gsum, state, mask, fl)
    with torch.no_grad():
        upd = {}
        for k, v in w.items():
            d = v - params[k]
            if kn["q"]:
                bits = 8 if kn["q"] == 1 else 2
                d = torch.stack([charlm.wire_round_trip(d[i], bits)
                                 for i in range(c)])
            m = mask[k].to(dev)
            upd[k] = d * m.reshape((1,) + tuple(m.shape)
                                   + (1,) * (d.ndim - 1 - m.ndim))
    return upd, (loss_sum / n).cpu().numpy()


def val_loss(params, val, model: Dict, fl: Dict, seed: int) -> float:
    rng = np.random.default_rng(seed + 777)
    dev = next(iter(params.values())).device
    out = []
    with torch.no_grad():
        p1 = {k: v.unsqueeze(0) for k, v in params.items()}
        for _ in range(fl["eval_batches"]):
            t, y = sample_batch(val, rng, fl["eval_batch_size"], fl["seq_len"])
            out.append(float(charlm.losses(
                p1, torch.from_numpy(t)[None].to(dev),
                torch.from_numpy(y)[None].to(dev), model)[0]))
    return float(np.mean(out))


def advance(cohort, streams, data, kn: Dict, fl: Dict) -> None:
    """The draws a round's LocalTrain takes from its clients' streams,
    taken without training (``sample_batch``'s draw, batch by batch)."""
    seq = fl["seq_len"]
    for cid in cohort:
        for _ in range(kn["s"] * kn["grad_accum"]):
            streams[cid].integers(0, len(data[cid]) - seq - 1,
                                  size=kn["b"])


def follow(params, train, val, model: Dict, fl: Dict, seed: int,
           init_duals: Dict[str, float], rounds: int,
           half_batch: bool = False, skip: int = 0) -> List[Dict]:
    """``rounds`` rounds from ``params`` (fp32, the device's): per round
    its val loss (at the round's start), knobs, mean train loss, duals
    after the round, the mean update, and the parameters after it.
    ``skip`` rounds go first without training (their cohorts, the draws
    from their clients' streams, knobs and duals), so that ``params``
    stand at the start of round ``skip + 1``."""
    n, k_round = fl["num_clients"], fl["clients_per_round"]
    data = shards(train, n)
    streams = [np.random.default_rng(seed + 1000 + i) for i in range(n)]
    rng = np.random.default_rng(seed)
    sizes = {k: v.numel() for k, v in params.items()}
    res = proxies(sum(sizes.values()), fl)
    lam = dict(init_duals)
    budgets = fl["budgets"]
    out = []
    for rnd in range(skip + rounds):
        training = rnd >= skip
        if training:
            vl = val_loss(params, val, model, fl, seed)
        cohort = [int(i) for i in rng.choice(n, size=k_round, replace=False)]
        kn = knobs(lam, fl)
        if training:
            upd, client_losses = local_train(params, cohort, streams, data,
                                             kn, model, fl, half_batch)
            with torch.no_grad():
                mean = {k: u.sum(dim=0) * (1.0 / len(cohort))
                        for k, u in upd.items()}
                params = {k: params[k] + mean[k] for k in params}
        else:
            advance(cohort, streams, data, kn, fl)
        use = usage(res, active_params(sizes, kn["k"], model), kn)
        us = [use] * len(cohort)
        new = {}
        for r in RESOURCES:
            m = sum(u[r] for u in us) / len(us)
            new[r] = dual_step(lam[r], m / budgets[r], fl["duals"])
        lam = new
        if training:
            out.append({"val_loss": vl, "knobs": kn, "duals": dict(lam),
                        "train_loss": float(np.mean(client_losses)),
                        "update": mean, "params": params})
    return out
