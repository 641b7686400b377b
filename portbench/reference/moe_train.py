"""Phi-3.5-MoE's train step in plain PyTorch (``moe_lm``'s layers under
autograd), for the training cell.

As the configuration and the traffic state it: each step takes
``rows`` sequences of ``seq`` tokens in ``microbatches`` equal slices
(one sequence each); a slice's loss is the mean next-token
cross-entropy over its tokens plus each layer's load-balance loss; the
step's loss and gradients are the slices' means. The freezing mask at
``mask_k``: the top ``mask_k`` layers, the final norm and the head
train; the lower layers and the embedding are frozen (no gradient
reaches them, and they do not move). AdamW (b1 0.9, b2 0.999, eps 1e-8,
bias-corrected, weight decay on the leaves of two or more axes in the
stacked layout, the step scaled by -lr) updates the trainable leaves,
and each leaf is kept in the configuration's dtype between steps (a
bf16 weight moves only by whole bf16 steps: at lr 1e-3 a norm's scale
of 1 does not move at all).

The reference keeps each stacked leaf as one tensor a layer, in fp32,
and follows the expert choices it is given (``moe_lm.moe``): the
program's, as the check reads them from its step, or, for the control,
the control's own. ``batch`` makes each step's inputs from the seed; the
program gets the same.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench.reference import moe_lm, weights

UNIT = "stack.units.b0."
B1, B2, EPS = 0.9, 0.999, 1e-8


def batch(cfg: Dict, seed: int, step: int, rows: int, seq: int, device
          ) -> Dict[str, torch.Tensor]:
    """Step ``step``'s inputs: ``rows`` sequences of ``seq`` + 1 token ids
    drawn on the device from the seed, uniform over the vocabulary ->
    {"tokens", "targets"} (rows, seq) int32, the targets one on."""
    gen = torch.Generator(device=device)
    gen.manual_seed(weights._seed_of(seed, "train_batch", step))
    ids = torch.randint(0, cfg["vocab_size"], (rows, seq + 1),
                        generator=gen, device=device, dtype=torch.int64)
    return {"tokens": ids[:, :-1].to(torch.int32),
            "targets": ids[:, 1:].to(torch.int32)}


def trainable(name: str, k: int, cfg: Dict) -> bool:
    """Leaf ``name`` (a stacked leaf's layer as ``name#i``) trains at
    ``k`` unfrozen top layers."""
    layers = cfg["num_layers"]
    k = max(1, min(k, layers))
    if "#" in name:
        return int(name.split("#")[1]) >= layers - k
    return not (name == "io.embed" and k < layers)


def leaves(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's weights as the configuration's dtypes round them, in
    fp32, a stacked leaf as one tensor a layer (``name#i``)."""
    out = {}
    for leaf in weights.leaf_specs(cfg):
        if leaf.stacked:
            for i in range(cfg["num_layers"]):
                out[f"{leaf.name}#{i}"] = weights.draw(
                    leaf, seed, device, i).to(torch.float32)
        else:
            out[leaf.name] = weights.draw(leaf, seed, device).to(
                torch.float32)
    return out


def change_norms(p: Dict[str, torch.Tensor], cfg: Dict, seed: int, device
                 ) -> Dict[str, float]:
    """Each leaf's (a stacked leaf's layer as ``name#i``) L2 norm of its
    change from the seed's weights, drawn again a leaf at a time."""
    out = {}
    for leaf in weights.leaf_specs(cfg):
        names = ([(f"{leaf.name}#{i}", i) for i in range(cfg["num_layers"])]
                 if leaf.stacked else [(leaf.name, None)])
        for name, i in names:
            now = p[name] if name in p else p[leaf.name][i]
            d = now.float() - weights.draw(leaf, seed, device, i).float()
            out[name] = float(torch.linalg.vector_norm(d))
            del d
    return out


def slice_loss(p: Dict[str, torch.Tensor], tokens, targets, cfg: Dict,
               mode: str, routes: Optional[List] = None):
    """One sequence (S,) -> (its loss, the choices each layer took, the
    widest routing margin)."""
    x = p["io.embed"][tokens.long()]
    aux, taken, gap = 0.0, [], 0.0
    for i in range(cfg["num_layers"]):
        w = {k[len(UNIT):].split("#")[0]: v for k, v in p.items()
             if k.startswith(UNIT) and k.endswith(f"#{i}")}
        given = None if routes is None else routes[i].reshape(
            -1, cfg["top_k"])
        x, _, rt = moe_lm.block(w, x, cfg, mode, given)
        aux = aux + rt["aux"]
        taken.append(rt["expert"].to(torch.uint8).cpu())
        gap = max(gap, rt["route_gap"])
    logits = moe_lm.head_logits(p, x, mode)
    ce = torch.nn.functional.cross_entropy(logits, targets.long())
    return ce + aux, taken, gap


def adamw_(p, g, state, name: str, stacked: bool, lr: float, wd: float,
           store: torch.dtype):
    """One AdamW step of leaf ``name`` in place, the new value rounded to
    ``store``, the dtype the configuration keeps the leaf in."""
    state["mu"][name] = B1 * state["mu"].get(name, 0.0) + (1 - B1) * g
    state["nu"][name] = B2 * state["nu"].get(name, 0.0) + (1 - B2) * g * g
    t = state["count"]
    step = ((state["mu"][name] / (1 - B1 ** t))
            / (torch.sqrt(state["nu"][name] / (1 - B2 ** t)) + EPS))
    if wd and p.ndim + int(stacked) >= 2:
        step = step + wd * p
    p.add_(-lr * step)
    p.copy_(p.to(store).to(torch.float32))


def follow(cfg: Dict, traffic: Dict, seed: int, device, mode: str = "fp32",
           routes: Optional[List] = None, half_batch: bool = False) -> Dict:
    """The first ``setup_steps`` steps from the seed -> {"loss": each
    step's, "grad": each trainable leaf's first-step gradient norm,
    "change": each leaf's change norm after the steps, "routes": the
    choices taken (step, slice, layer), "route_gap": the widest routing
    margin}. ``routes`` (the same nesting) is followed where given;
    ``half_batch`` leaves out the second half of each step's rows and
    takes the mean over the rest (a fault)."""
    rows, seq = traffic["rows"], traffic["seq"]
    mb = traffic["microbatches"]
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p = leaves(cfg, seed, device)
        store = {}
        for leaf in weights.leaf_specs(cfg):
            for i in range(cfg["num_layers"] if leaf.stacked else 1):
                name = f"{leaf.name}#{i}" if leaf.stacked else leaf.name
                store[name] = weights.DTYPES[leaf.dtype]
        train = [k for k in p if trainable(k, traffic["mask_k"], cfg)]
        for k in train:
            p[k].requires_grad_(True)
        state = {"mu": {}, "nu": {}, "count": 0}
        out = {"loss": [], "routes": [], "route_gap": 0.0}
        for step in range(traffic["setup_steps"]):
            b = batch(cfg, seed, step, rows, seq, device)
            use = list(range(mb // 2 if half_batch else mb))
            per = rows // mb
            gsum = {k: torch.zeros_like(p[k]) for k in train}
            loss_sum, taken = 0.0, []
            for j in use:
                given = (routes[step][j] if routes is not None
                         and j < len(routes[step]) else None)
                loss, rt, gap = slice_loss(
                    p, b["tokens"][j * per:(j + 1) * per].reshape(-1),
                    b["targets"][j * per:(j + 1) * per].reshape(-1), cfg,
                    mode, given)
                grads = torch.autograd.grad(loss, [p[k] for k in train])
                for k, g in zip(train, grads):
                    gsum[k] += g
                loss_sum += float(loss.detach())
                taken.append(rt)
                out["route_gap"] = max(out["route_gap"], gap)
            out["loss"].append(loss_sum / len(use))
            out["routes"].append(taken)
            state["count"] += 1
            with torch.no_grad():
                for k in train:
                    g = gsum.pop(k) / len(use)
                    if step == 0:
                        out.setdefault("grad", {})[k] = float(
                            torch.linalg.vector_norm(g.double()))
                    adamw_(p[k], g, state, k, "#" in k, traffic["lr"],
                           traffic["weight_decay"], store[k])
        with torch.no_grad():
            out["change"] = change_norms(p, cfg, seed, device)
        for k in p:
            out["grad"].setdefault(k, 0.0)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
