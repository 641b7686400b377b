"""Shared setup of the port's parity tests (``tests/test_torch_*.py``).

The tiny char-LM and federated setting of
``tests/test_golden_trajectories.py``, built in both packages, and
parameters initialised by JAX and bridged into the port: torch cannot
reproduce ``jax.random``, so both packages run from the same weights.
"""
import dataclasses

import jax
import numpy as np

from repro.configs import get_config, get_fl_config
from repro.data import load_corpus
from repro.models import build as jbuild
from repro_torch.configs import charlm_shakespeare as tcs

TINY_MODEL = dict(num_layers=3, d_model=48, num_heads=4, num_kv_heads=4,
                  head_dim=12, d_ff=96)
TINY_FL = dict(num_clients=4, clients_per_round=2, s_base=3,
               b_base=8, seq_len=16, eval_batches=1, eval_batch_size=8)


def tiny_setup():
    """-> (dataset, jax cfg, jax fl, port cfg, port fl)."""
    ds = load_corpus(target_bytes=60_000)
    vocab = max(ds.vocab_size, 64)
    jcfg = get_config("charlm-shakespeare").replace(vocab_size=vocab,
                                                    **TINY_MODEL)
    tcfg = tcs.CONFIG.replace(vocab_size=vocab, **TINY_MODEL)
    jfl = get_fl_config().replace(**TINY_FL)
    jfl = jfl.replace(duals=dataclasses.replace(jfl.duals, s_min=2, b_min=4))
    tfl = tcs.FL.replace(**TINY_FL)
    tfl = tfl.replace(duals=dataclasses.replace(tfl.duals, s_min=2, b_min=4))
    return ds, jcfg, jfl, tcfg, tfl


def jax_params(jcfg, seed: int = 0):
    """JAX-initialised params as a nested dict of NumPy arrays."""
    params = jbuild(jcfg).init(jax.random.PRNGKey(seed))
    return jax.tree.map(lambda a: np.array(a, copy=True), params)


def flat_paths(tree, prefix=""):
    """JAX tree -> {dotted path: leaf}, in JAX's own leaf order."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(k.key) for k in path): leaf for path, leaf in leaves}
