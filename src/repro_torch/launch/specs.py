"""Input and decode-cache stand-ins for every (architecture x input
shape): tensors on the meta device, with the reference's shapes and
dtypes (``repro.launch.specs.input_specs`` / ``cache_specs``), so that
nothing is allocated. The dry-run turns them into fake tensors.

The reference's sharding recipe (``param_shardings``,
``batch_shardings``, ``cache_shardings``) is not ported (ROADMAP queue 1
item 13c).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Batch stand-ins for train / prefill; decode adds cache stand-ins
    separately. An encoder-decoder splits the length into source frames
    and target tokens (at decode the source is the fixed 4,096-frame
    memory); a vision frontend's patch tokens come out of the text
    length."""
    b, s = shape.global_batch, shape.seq_len
    out = {}
    if cfg.encdec:
        s_src, s_tgt = s // 2, s - s // 2
        if shape.kind == "decode":
            s_src = min(s_src, 4096)        # fixed encoder memory at decode
        out["src_embeds"] = sds((b, s_src, cfg.frontend.embed_dim),
                                torch.float32)
        out["tokens"] = sds((b, s_tgt), torch.int32)
        if shape.kind == "train":
            out["targets"] = sds((b, s_tgt), torch.int32)
        return out
    n_text = s
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        out["patch_embeds"] = sds((b, cfg.frontend.num_prefix_tokens,
                                   cfg.frontend.embed_dim), torch.float32)
        n_text = s - cfg.frontend.num_prefix_tokens
    out["tokens"] = sds((b, n_text), torch.int32)
    if shape.kind == "train":
        out["targets"] = sds((b, n_text), torch.int32)
    return out


def cache_specs(model, cfg: ModelConfig, shape: InputShape):
    """Decode-cache stand-ins (``long_500k`` windows the global layers'
    caches by ``decode_window``; an encoder-decoder's cross K/V cover
    4,096 source frames)."""
    long = shape.name == "long_500k"
    if cfg.encdec:
        return model.init_cache(shape.global_batch, shape.seq_len, long=long,
                                src_len=4096, device=META)
    return model.init_cache(shape.global_batch, shape.seq_len, long=long,
                            device=META)
