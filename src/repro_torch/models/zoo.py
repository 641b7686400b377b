"""Model zoo: the ``Model`` of every architecture of the reference (the
char-LM, Gemma2, the attention-based zoo: dense, MoE, MLA and the
vision-prefixed PaliGemma; the recurrent stacks: RecurrentGemma's RG-LRU
and local attention, xLSTM's mLSTM and sLSTM; and SeamlessM4T's
encoder-decoder, ``models.encdec.EncDecModel``).

``build(cfg)`` returns a ``Model``:

    init(gen, device=None) -> ParamTree
    train_loss(params, batch, remat=False) -> (ce + aux, {"ce", "aux"})
    prefill(params, batch, use_decode_window=False, max_new_tokens=0)
        -> (last_logits (B, 1, V) fp32, decode caches)
    decode_step(params, caches, tokens (B, 1)) -> (logits (B, 1, V), caches)
    init_cache(batch_size, ctx_len, long=False, device=None) -> caches
    param_count() -> {"total", "active"}

``params`` is a ``ParamTree`` or the parameter dict (dotted JAX paths ->
tensors, see ``models.convert``). A batch holds integer ``tokens`` (and
``targets`` for the loss) of shape (B, S), optionally a ``loss_mask``
(B, S) and, for a vision frontend, ``patch_embeds`` (B, P, E_f): those
are projected by ``frontend_proj`` and prepended to the tokens, and cut
again before the loss. The embedding may be tied (the unembedding is
``embed.T``) or not (``head``), scaled by sqrt(d) (Gemma) and joined by
learned positions (the char-LM). Prefill runs without a gradient, so
its attention is the flash kernel on the card; ``decode_step`` updates
the caches in place and returns them. An encoder-decoder batch carries
``src_embeds`` (B, S_src, E_f) instead of patches (see
``models.encdec``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.moe import moe_param_count
from repro_torch.models.convert import ParamTree, as_params, flatten, unflatten


def _ce_chunk_size(batch: int, vocab: int, seq: int) -> int:
    """The reference's chunk of sequence positions: ~8 GiB of fp32 logits
    at most, at least 16 positions, at most 1,024 and the sequence, and a
    divisor of the sequence."""
    budget = 2 ** 33
    c = max(16, int(budget / max(1, batch * vocab * 4)))
    c = min(c, seq, 1024)
    while seq % c:
        c -= 1
    return max(c, 1)


def _ce_chunk(xc, w_unembed, tc, mc, softcap):
    """One chunk's (sum of (lse - ll) * mask, sum of mask) in fp32."""
    logits = L.dense(xc, w_unembed).to(torch.float32)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    lse = torch.logsumexp(logits, dim=-1)
    ll = L.take_along_last(logits, tc)
    return torch.sum((lse - ll) * mc), torch.sum(mc)


def ce_loss(x, w_unembed, targets, softcap: Optional[float] = None,
            mask=None, remat: bool = False):
    """x: (B,S,D), w_unembed: (D,V), targets: (B,S) -> mean CE in fp32
    (over softcapped logits when ``softcap`` is set), over the tokens
    where ``mask`` (B,S) is set (every token without one):
    sum((lse - ll) * mask) / max(sum(mask), 1).

    The reference's ``chunked_ce_loss``: the sequence runs in chunks of
    ``_ce_chunk_size`` positions, their partial sums added in order, so
    that no (B, S, V) logits tensor is live at once. Under ``remat`` each
    chunk's logits are recomputed in the backward pass (the reference's
    ``jax.checkpoint``) instead of kept for it."""
    b, s, _ = x.shape
    c = _ce_chunk_size(b, w_unembed.shape[1], s)
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    mask = mask.to(torch.float32)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        args = (x[:, i:i + c], w_unembed, targets[:, i:i + c],
                mask[:, i:i + c], softcap)
        part, n = (checkpoint(_ce_chunk, *args, use_reentrant=False)
                   if remat else _ce_chunk(*args))
        tot, cnt = tot + part, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def io_init(gen, cfg: ModelConfig, device):
    p = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                               cfg.param_dtype, device),
         "final_norm": L.norm_init(cfg, device)}
    if not cfg.tie_embeddings:
        p["head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                 cfg.param_dtype, device)
    if cfg.learned_pos_emb:
        p["pos_embed"] = L.embed_init(gen, cfg.learned_pos_emb, cfg.d_model,
                                      cfg.param_dtype, device)
    if cfg.frontend is not None:
        p["frontend_proj"] = L.dense_init(gen, cfg.frontend.embed_dim,
                                          cfg.d_model, cfg.param_dtype, device)
    return p


def embed_tokens(p, tokens, cfg: ModelConfig, positions=None):
    """Token embedding (times sqrt(d) under ``embed_scale``) plus the
    learned position of each column, or of ``positions`` (decode)."""
    s = tokens.shape[1]
    x = L.lookup_rows(p["embed"], tokens).to(cfg.compute_dtype)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    if cfg.learned_pos_emb:
        pos = (p["pos_embed"][:s] if positions is None
               else p["pos_embed"][positions.long()])
        x = x + pos.to(cfg.compute_dtype)
    return x


def unembed_matrix(p, cfg: ModelConfig):
    return p["embed"].T if cfg.tie_embeddings else p["head"]


def logits_fn(p, x, cfg: ModelConfig):
    logits = L.dense(x, unembed_matrix(p, cfg)).to(torch.float32)
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _decode_positions(caches) -> Optional[torch.Tensor]:
    """Absolute position of the new token, (1, 1): any attention cache's
    index (the stacked per-unit indices are all equal); None for a
    purely recurrent stack (no attention cache, positions unused)."""
    def find(tree):
        if isinstance(tree, dict):
            if "index" in tree:
                return tree["index"]
            tree = list(tree.values())
        if isinstance(tree, (list, tuple)):
            for v in tree:
                r = find(v)
                if r is not None:
                    return r
        return None

    idx = find(caches)
    if idx is None:
        return None
    return idx.reshape(-1)[0].reshape(1, 1)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def _init_tree(self, gen, dev: torch.device):
        """The parameters as a nested dict of tensors (the JAX layout)."""
        return {"io": io_init(gen, self.cfg, dev),
                "stack": T.stack_init(gen, self.cfg, dev)}

    def init(self, gen: torch.Generator, device: DeviceLike = None
             ) -> ParamTree:
        """Fresh parameters from ``gen``, drawn on the generator's device
        and moved to ``device`` (a CPU generator gives the same weights on
        every device; a CUDA generator draws on the card, leaf by leaf):
        normal x 1/sqrt(fan_in) for matrices, normal x 0.02 for the
        embeddings, ones/zeros for norms and biases (zeros for the RMS
        norm's ``1 + scale``)."""
        return ParamTree(flatten(self._init_tree(gen, resolve_device(device))))

    def _forward(self, params, batch, cache_extra: Optional[int] = None,
                 use_decode_window: bool = False, remat: bool = False):
        """Embed (patch tokens first), run the stack and the final norm ->
        (param tree, x, caches with ``cache_extra`` slots past the
        context, or None without it, aux loss)."""
        cfg = self.cfg
        p = unflatten(as_params(params))
        x = embed_tokens(p["io"], batch["tokens"], cfg)
        if cfg.frontend is not None and "patch_embeds" in batch:
            patches = L.dense(batch["patch_embeds"].to(cfg.compute_dtype),
                              p["io"]["frontend_proj"])
            x = torch.cat([patches, x], dim=1)
        x = L.shard_batch(x)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device,
                                 dtype=torch.int32).expand(b, s)
        cache_len = None if cache_extra is None else s + cache_extra
        x, caches, aux = T.stack_apply_full(p["stack"], x, positions, cfg,
                                            cache_len, use_decode_window,
                                            remat)
        return p, L.norm_apply(p["io"]["final_norm"], x), caches, aux

    def train_loss(self, params, batch, remat: bool = False):
        """-> (ce + aux, {"ce", "aux"}): the mean cross-entropy over the
        text tokens (under ``loss_mask`` when the batch has one) and the
        MoE load-balance loss summed over the layers (0.0 without MoE).
        ``remat`` recomputes each stacked unit and each loss chunk in the
        backward pass, as the reference's train loss always does
        (``launch.steps.make_train_step`` asks for it; the federated
        client, whose char-LM fits, does not): the same values with less
        memory and more work."""
        cfg = self.cfg
        p, x, _, aux = self._forward(params, batch, remat=remat)
        if cfg.frontend is not None:
            x = x[:, cfg.frontend.num_prefix_tokens:]
        w = unembed_matrix(p["io"], cfg).to(cfg.compute_dtype)
        ce = ce_loss(x, w, batch["targets"], cfg.final_softcap,
                     batch.get("loss_mask"), remat)
        return (ce if cfg.moe is None else ce + aux), {"ce": ce, "aux": aux}

    @torch.no_grad()
    def prefill(self, params, batch, use_decode_window: bool = False,
                max_new_tokens: int = 0):
        """-> (logits of the last position (B, 1, V) fp32, decode caches
        with room for ``max_new_tokens`` more tokens in global layers)."""
        p, x, caches, _ = self._forward(params, batch, max_new_tokens,
                                        use_decode_window)
        return logits_fn(p["io"], x[:, -1:], self.cfg), caches

    @torch.no_grad()
    def decode_step(self, params, caches, tokens):
        """tokens: (B, 1) -> (logits (B, 1, V) fp32, caches updated in
        place)."""
        cfg = self.cfg
        p = unflatten(as_params(params))
        x = embed_tokens(p["io"], tokens, cfg,
                         positions=_decode_positions(caches))
        x = L.shard_batch(x)
        x, caches = T.stack_apply_decode(p["stack"], x, caches, cfg)
        x = L.norm_apply(p["io"]["final_norm"], x)
        return logits_fn(p["io"], x, cfg), caches

    def init_cache(self, batch_size: int, ctx_len: int, long: bool = False,
                   device: DeviceLike = None):
        return T.stack_cache_init(self.cfg, batch_size, ctx_len,
                                  use_decode_window=long,
                                  device=resolve_device(device))

    def param_count(self) -> Dict[str, int]:
        """Counted from shapes on the meta device, so nothing is
        allocated. Every parameter is active but the experts an MoE layer
        does not route a token to (``moe_param_count``)."""
        cfg = self.cfg
        tree = self._init_tree(None, torch.device("meta"))
        total = sum(math.prod(t.shape) for t in flatten(tree).values())
        active = total
        if cfg.moe is not None:
            per_layer = moe_param_count(cfg)
            n_moe = sum(T.block_spec(cfg, i).use_moe
                        for i in range(cfg.num_layers))
            active = total - n_moe * (per_layer["total"] - per_layer["active"])
        return {"total": total, "active": active}


def build(cfg: ModelConfig) -> Model:
    if cfg.encdec:
        from repro_torch.models.encdec import EncDecModel
        return EncDecModel(cfg)
    return Model(cfg)
