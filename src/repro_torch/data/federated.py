"""Federated partition of the char corpus across N clients.

Contiguous shards give mild natural non-IIDness (different plays /
speakers dominate different shards); ``noniid_alpha > 0`` additionally
skews shard sizes with a Dirichlet draw, the standard FL heterogeneity
knob.

Two invariants the fleet-dynamics layer relies on:

* **Non-empty shards.** Extreme Dirichlet draws can push a weight so
  low that ``int(w_i * len)`` truncates to zero; the partition guard
  below steals the deficit from the largest shard so every client owns
  at least one byte (and ``batch`` can always index it).
* **Per-client RNG isolation.** Each client draws batches from its own
  generator stream, so the batches a client sees depend only on how
  many times *that client* trained — never on which other clients were
  sampled, dropped, or reordered around it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.shakespeare import sample_batch


def _shard_sizes(w: np.ndarray, total: int) -> np.ndarray:
    """Integer shard sizes summing to ``total``, every shard >= 1.

    Truncate each weight, give the rounding remainder to the last shard
    (the seed behavior), then repair any zero-length shard by taking
    from the currently largest one.
    """
    sizes = (w * total).astype(int)
    sizes[-1] += total - sizes.sum()
    for i in range(len(sizes)):
        if sizes[i] < 1:
            j = int(np.argmax(sizes))
            take = 1 - sizes[i]
            assert sizes[j] - take >= 1, "corpus too small for num_clients"
            sizes[j] -= take
            sizes[i] = 1
    return sizes


class FederatedData:
    def __init__(self, data: np.ndarray, num_clients: int, seed: int = 0,
                 noniid_alpha: float = 0.0):
        assert len(data) >= num_clients, "corpus smaller than the fleet"
        self.num_clients = num_clients
        rng = np.random.default_rng(seed)
        if noniid_alpha > 0:
            w = rng.dirichlet([noniid_alpha] * num_clients)
            w = np.maximum(w, 2.0 / num_clients)  # every client gets data
            w = w / w.sum()
        else:
            w = np.full(num_clients, 1.0 / num_clients)
        bounds = np.concatenate([[0], np.cumsum(_shard_sizes(w, len(data)))])
        self.shards = [data[bounds[i]:bounds[i + 1]]
                       for i in range(num_clients)]
        self.seed = seed
        self._rngs: list = []
        self.reset_rngs()

    def reset_rngs(self) -> None:
        """Rewind every client's batch stream to its seeded origin.

        The generators are mutable run state: a second ``run()`` on the
        same engine continues the streams (fresh batches — the warm-
        continuation behaviour). Replay tooling calls this so a re-run
        draws the exact same batches."""
        self._rngs = [np.random.default_rng(self.seed + 1000 + i)
                      for i in range(self.num_clients)]

    def shard_size(self, i: int) -> int:
        return len(self.shards[i])

    def batch(self, client: int, batch_size: int, seq: int):
        return sample_batch(self.shards[client], self._rngs[client],
                            batch_size, seq)
