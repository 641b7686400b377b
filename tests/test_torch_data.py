"""The port's data pipeline yields byte-identical data to the reference:
the corpus, every client's batch stream, and the eval batches."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import federated as jfed  # noqa: E402
from repro.data import shakespeare as jshk  # noqa: E402
from repro_torch.data import federated as tfed  # noqa: E402
from repro_torch.data import shakespeare as tshk  # noqa: E402


@pytest.fixture(scope="module")
def corpora():
    return jshk.load_corpus(target_bytes=60_000), \
        tshk.load_corpus(target_bytes=60_000)


def test_corpus_identical(corpora):
    j, t = corpora
    assert tshk._expand(60_000) == jshk._expand(60_000)
    for a, b in ((j.train, t.train), (j.val, t.val)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert j.vocab_size == t.vocab_size and j.stoi == t.stoi


def test_default_corpus_identical():
    j, t = jshk.load_corpus(), tshk.load_corpus()
    assert j.train.tobytes() == t.train.tobytes()
    assert j.val.tobytes() == t.val.tobytes()


@pytest.mark.parametrize("noniid_alpha", [0.0, 0.5])
def test_client_batch_streams_identical(corpora, noniid_alpha):
    """One default_rng(seed + 1000 + i) per client: the same shards and the
    same batches in the same order, whatever order clients draw in."""
    j, _ = corpora
    fj = jfed.FederatedData(j.train, 4, seed=3, noniid_alpha=noniid_alpha)
    ft = tfed.FederatedData(j.train, 4, seed=3, noniid_alpha=noniid_alpha)
    for a, b in zip(fj.shards, ft.shards):
        np.testing.assert_array_equal(a, b)
    for client in (2, 0, 2, 3, 1, 2):
        bj = fj.batch(client, 8, 16)
        bt = ft.batch(client, 8, 16)
        for key in ("tokens", "targets"):
            assert bt[key].dtype == np.int32
            assert bj[key].tobytes() == bt[key].tobytes()


def test_eval_batches_identical(corpora):
    """make_eval_fn draws its batches from default_rng(seed + 777)."""
    j, t = corpora
    rj = np.random.default_rng(0 + 777)
    rt = np.random.default_rng(0 + 777)
    for _ in range(3):
        bj = jshk.sample_batch(j.val, rj, 8, 16)
        bt = tshk.sample_batch(t.val, rt, 8, 16)
        assert bj["tokens"].tobytes() == bt["tokens"].tobytes()
        assert bj["targets"].tobytes() == bt["targets"].tobytes()
