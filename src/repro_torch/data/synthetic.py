"""Synthetic token / embedding batches for smoke runs, as
``repro.data.synthetic``: the same NumPy draws from the same seed, in the
same order, so both packages get identical arrays."""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0):
    """-> {"tokens", "targets": (B, S_text) int32} as NumPy arrays. An
    encoder-decoder splits ``seq`` into source frames ``src_embeds`` (B,
    seq // 2, E_f) float32 and seq - seq // 2 target tokens; a vision
    frontend adds ``patch_embeds`` (B, P, E_f) float32, whose P patch
    tokens count toward ``seq`` (S_text = seq - P)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.encdec:
        s_src, s_tgt = seq // 2, seq - seq // 2
        out["src_embeds"] = rng.normal(
            size=(batch, s_src, cfg.frontend.embed_dim)).astype(np.float32)
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (batch, s_tgt)).astype(np.int32)
        out["targets"] = rng.integers(0, cfg.vocab_size,
                                      (batch, s_tgt)).astype(np.int32)
        return out
    n_text = seq
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        n_prefix = cfg.frontend.num_prefix_tokens
        n_text = seq - n_prefix
        out["patch_embeds"] = rng.normal(
            size=(batch, n_prefix, cfg.frontend.embed_dim)).astype(np.float32)
    out["tokens"] = rng.integers(0, cfg.vocab_size,
                                 (batch, n_text)).astype(np.int32)
    out["targets"] = rng.integers(0, cfg.vocab_size,
                                  (batch, n_text)).astype(np.int32)
    return out
