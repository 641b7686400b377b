"""The encoder-decoder backbone (SeamlessM4T-medium) in PyTorch, as
``repro.models.encdec``.

The modality frontend is a stub, as in the reference: ``src_embeds``
arrive as precomputed frame embeddings of width
``cfg.frontend.embed_dim`` and are projected into the encoder. Encoder
layers are pre-norm bidirectional self-attention (RoPE on q and k) and
an MLP; decoder layers are causal self-attention (cached), cross-
attention over the encoder's output and an MLP. Both stacks keep the
reference's leading layer axis (``enc`` (n_enc, ...), ``dec`` (n_dec,
...)), looped over in Python as the decoder stack's units are.

Without a gradient every attention is the flash kernel on the card: the
encoder's and the cross-attention's with ``causal=False`` (the cross-
attention's q and k differ in length, and in decode q is one token),
the decoder's causal. Decode's self-attention is the plain
``decode_attention`` over the rolling cache. Prefill computes each
decoder layer's cross K/V from the encoder's output once and keeps them
as the decode cache: ``{"self": {"k", "v": (n_dec, B, S_buf, KVH, D),
"index": (n_dec,)}, "cross_k", "cross_v": (n_dec, B, S_src, KVH, D)}``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import zoo as Z
from repro_torch.models.convert import as_params, unflatten


def _enc_layer_init(gen, cfg, device):
    return {"ln1": L.norm_init(cfg, device),
            "attn": L.attn_init(gen, cfg, device),
            "ln2": L.norm_init(cfg, device),
            "ffn": L.mlp_init(gen, cfg, device)}


def _dec_layer_init(gen, cfg, device):
    return {"ln1": L.norm_init(cfg, device),
            "self_attn": L.attn_init(gen, cfg, device),
            "ln_x": L.norm_init(cfg, device),
            "cross_attn": L.attn_init(gen, cfg, device),
            "ln2": L.norm_init(cfg, device),
            "ffn": L.mlp_init(gen, cfg, device)}


def _enc_layer(p, x, cfg):
    b, s, _ = x.shape
    q, k, v = L._qkv(p["attn"], L.norm_apply(p["ln1"], x), cfg)
    pos = torch.arange(s, device=x.device, dtype=torch.int32).expand(b, s)
    q = L.rope(q, pos, cfg.rope_theta)
    k = L.rope(k, pos, cfg.rope_theta)
    x = x + L.bidir_attention(q, k, v).reshape(b, s, -1) @ p["attn"]["wo"]
    return x + L.mlp_apply(p["ffn"], L.norm_apply(p["ln2"], x), cfg)


def _cross_kv(p, memory, cfg):
    """A decoder layer's cross-attention K and V from the encoder's
    output: (B, S_src, KVH, D) each."""
    b, s, _ = memory.shape
    shape = (b, s, cfg.num_kv_heads, cfg.head_dim)
    return ((memory @ p["cross_attn"]["wk"]).reshape(shape),
            (memory @ p["cross_attn"]["wv"]).reshape(shape))


def _cross_attend(p, x, k_enc, v_enc, cfg):
    b, s, _ = x.shape
    q = (x @ p["cross_attn"]["wq"]).reshape(b, s, cfg.num_heads,
                                            cfg.head_dim)
    out = L.bidir_attention(q, k_enc, v_enc)
    return out.reshape(b, s, -1) @ p["cross_attn"]["wo"]


def _dec_layer_full(p, x, positions, k_enc, v_enc, cfg):
    """-> (x, the self-attention's post-RoPE (k, v))."""
    h = L.norm_apply(p["ln1"], x)
    a, kv = L.attn_apply_full(p["self_attn"], h, positions, cfg, window=None)
    x = x + a
    x = x + _cross_attend(p, L.norm_apply(p["ln_x"], x), k_enc, v_enc, cfg)
    return x + L.mlp_apply(p["ffn"], L.norm_apply(p["ln2"], x), cfg), kv


def _dec_layer_decode(p, x, cache, k_enc, v_enc, cfg):
    h = L.norm_apply(p["ln1"], x)
    a, _ = L.attn_apply_decode(p["self_attn"], h, cache, cfg, window=None)
    x = x + a
    x = x + _cross_attend(p, L.norm_apply(p["ln_x"], x), k_enc, v_enc, cfg)
    return x + L.mlp_apply(p["ffn"], L.norm_apply(p["ln2"], x), cfg)


class EncDecModel(Z.Model):
    """``Model``'s interface over the encoder-decoder: a batch carries
    ``src_embeds`` (B, S_src, E_f) float32 beside the target ``tokens``
    (and ``targets`` for the loss); ``init_cache`` takes the source
    length ``src_len``."""

    def _init_tree(self, gen, dev: torch.device):
        cfg = self.cfg
        io = Z.io_init(gen, cfg, dev)
        io["enc_norm"] = L.norm_init(cfg, dev)
        return {"io": io,
                "enc": T._stack_units(lambda u: _enc_layer_init(gen, cfg, dev),
                                      cfg.enc_layers),
                "dec": T._stack_units(lambda u: _dec_layer_init(gen, cfg, dev),
                                      cfg.num_layers)}

    def encode(self, p, src_embeds, remat: bool = False):
        """The projected source frames through the encoder and its final
        norm -> memory (B, S_src, d); under ``remat`` each layer is
        recomputed in the backward pass (the reference's
        ``jax.checkpoint``)."""
        cfg = self.cfg
        x = src_embeds.to(cfg.compute_dtype) @ p["io"]["frontend_proj"]

        def layer(u, h):
            return _enc_layer(T._unit_slice(p["enc"], u), h, cfg)

        for u in range(cfg.enc_layers):
            x = (checkpoint(layer, u, x, use_reentrant=False) if remat
                 else layer(u, x))
        return L.norm_apply(p["io"]["enc_norm"], x)

    def _decode_full(self, p, memory, tokens, s_buf: Optional[int] = None,
                     remat: bool = False):
        """The decoder over the full target sequence -> (x after the final
        norm, the decode caches with ``s_buf`` self-attention slots, or
        None without it); under ``remat`` (no caches) each layer, its
        cross K/V included, is recomputed in the backward pass."""
        cfg = self.cfg
        x = Z.embed_tokens(p["io"], tokens, cfg)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device,
                                 dtype=torch.int32).expand(b, s)

        def run(u):
            nonlocal x
            lp = T._unit_slice(p["dec"], u)
            k_enc, v_enc = _cross_kv(lp, memory, cfg)
            x, (k, v) = _dec_layer_full(lp, x, positions, k_enc, v_enc, cfg)
            return {"self": L.attn_cache_from_full(k, v, s_buf),
                    "cross_k": k_enc, "cross_v": v_enc}

        def layer(u, h):
            lp = T._unit_slice(p["dec"], u)
            return _dec_layer_full(lp, h, positions, *_cross_kv(lp, memory,
                                                                cfg), cfg)[0]

        caches = None
        if s_buf is None:
            for u in range(cfg.num_layers):
                x = (checkpoint(layer, u, x, use_reentrant=False) if remat
                     else layer(u, x))
        else:
            caches = T._stack_units(run, cfg.num_layers)
        return L.norm_apply(p["io"]["final_norm"], x), caches

    def train_loss(self, params, batch, remat: bool = False):
        """-> (ce, {"ce", "aux": 0.0}): the mean cross-entropy over the
        target tokens (under ``loss_mask`` when the batch has one);
        ``remat`` as ``Model.train_loss``."""
        cfg = self.cfg
        p = unflatten(as_params(params))
        memory = self.encode(p, batch["src_embeds"], remat)
        x, _ = self._decode_full(p, memory, batch["tokens"], remat=remat)
        w = Z.unembed_matrix(p["io"], cfg).to(cfg.compute_dtype)
        ce = Z.ce_loss(x, w, batch["targets"], cfg.final_softcap,
                       batch.get("loss_mask"), remat)
        return ce, {"ce": ce, "aux": 0.0}

    @torch.no_grad()
    def prefill(self, params, batch, use_decode_window: bool = False,
                max_new_tokens: int = 0):
        """-> (logits of the last target position (B, 1, V) fp32, decode
        caches with room for ``max_new_tokens`` more tokens)."""
        cfg = self.cfg
        p = unflatten(as_params(params))
        memory = self.encode(p, batch["src_embeds"])
        s_buf = batch["tokens"].shape[1] + max_new_tokens
        if use_decode_window and cfg.decode_window:
            s_buf = min(s_buf, cfg.decode_window)
        x, caches = self._decode_full(p, memory, batch["tokens"], s_buf)
        return Z.logits_fn(p["io"], x[:, -1:], cfg), caches

    @torch.no_grad()
    def decode_step(self, params, caches, tokens):
        """tokens: (B, 1) -> (logits (B, 1, V) fp32, caches updated in
        place)."""
        cfg = self.cfg
        p = unflatten(as_params(params))
        x = Z.embed_tokens(p["io"], tokens, cfg)
        for u in range(cfg.num_layers):
            x = _dec_layer_decode(T._unit_slice(p["dec"], u), x,
                                  T._unit_slice(caches["self"], u),
                                  caches["cross_k"][u], caches["cross_v"][u],
                                  cfg)
        x = L.norm_apply(p["io"]["final_norm"], x)
        return Z.logits_fn(p["io"], x, cfg), caches

    def init_cache(self, batch_size: int, ctx_len: int, long: bool = False,
                   src_len: int = 4096, device: DeviceLike = None):
        cfg, dev = self.cfg, resolve_device(device)
        s_buf = ctx_len
        if long and cfg.decode_window:
            s_buf = min(s_buf, cfg.decode_window)
        shape = (cfg.num_layers, batch_size, src_len, cfg.num_kv_heads,
                 cfg.head_dim)
        return {"self": T._stack_units(
                    lambda u: L.attn_cache_init(cfg, batch_size, s_buf, dev),
                    cfg.num_layers),
                "cross_k": torch.zeros(shape, dtype=cfg.compute_dtype,
                                       device=dev),
                "cross_v": torch.zeros(shape, dtype=cfg.compute_dtype,
                                       device=dev)}
