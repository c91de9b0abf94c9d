"""rename / clone / join_indexes of the port on the CPU, ported from
`tests/test_misc_api.py`, and `join_indexes` against vss_tpu's on the
same two indexes (natively built on one thread, so equal graphs; the
vectors are small integers, so every distance is exact in both packages
and the matchings must be the same dictionary).
"""
import numpy as np
import pytest
import torch

import vss_tpu.index.dense as jdense
from vss_tpu.index.graph import HNSWConfig as JConfig
from vss_tpu.index.join import join_indexes as jax_join_indexes
from vss_tpu_torch import HNSWConfig, HNSWIndex
from vss_tpu_torch.index.join import join_indexes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers at once, each with JAX's own thread
    pool: PyTorch's intra-op threads then contend for the same cores and
    the small eager ops of a wave get many times slower. One thread per
    worker is the faster setting there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def idx(rng):
    vecs = rng.standard_normal((300, 12)).astype(np.float32)
    return HNSWIndex.build(vecs, HNSWConfig(dims=12), wave_size=128, device="cpu"), vecs


def _top1(index, v):
    _, rows = index.search(v[None], k=1)
    return int(rows[0, 0])


def test_rename(idx):
    index, vecs = idx
    assert index.rename(5, 9005)
    assert _top1(index, vecs[5]) == 9005
    assert not index.rename(5, 10)  # old id gone
    with pytest.raises(ValueError, match="already exists"):
        index.rename(9005, 7)
    assert _top1(index, vecs[5]) == 9005  # the failed rename changed nothing


def test_clone_independent(idx):
    index, vecs = idx
    c = index.clone()
    c.delete([3])
    assert c.count == 299 and index.count == 300
    assert _top1(index, vecs[3]) == 3
    # an insert into the clone leaves the original's tensors alone
    before = index.graph.adj0.clone()
    c.insert(vecs[:2] + 5.0, [800, 801])
    assert (index.graph.adj0 == before).all() and index.count == 300 and c.count == 301
    assert _top1(c, vecs[0] + 5.0) == 800


def test_join_indexes(rng):
    # b = permuted copy of a's vectors -> perfect matching expected
    vecs = rng.standard_normal((200, 16)).astype(np.float32)
    perm = rng.permutation(200)
    cfg = HNSWConfig(dims=16)
    a = HNSWIndex.build(vecs, cfg, wave_size=64, device="cpu")
    b = HNSWIndex.build(vecs[perm], cfg, rowids=np.arange(1000, 1200), wave_size=64,
                        device="cpu")
    m = join_indexes(a, b, proposals=8)
    good = sum(1 for ar, br in m.items() if perm[br - 1000] == ar)
    assert len(m) >= 190
    assert good / len(m) >= 0.95


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_join_indexes_matches_jax(storage):
    rng = np.random.default_rng(5)
    va = rng.integers(-8, 9, (150, 16)).astype(np.float32)
    vb = va[rng.permutation(150)][:120] + rng.integers(-1, 2, (120, 16)).astype(np.float32)
    rb = np.arange(500, 620)
    kw = dict(dims=16, storage_dtype=storage)
    ja = jdense.HNSWIndex.build(va, JConfig(**kw))
    jb = jdense.HNSWIndex.build(vb, JConfig(**kw), rowids=rb)
    ta = HNSWIndex.build(va, HNSWConfig(**kw), device="cpu")
    tb = HNSWIndex.build(vb, HNSWConfig(**kw), rowids=rb, device="cpu")
    want = jax_join_indexes(ja, jb, proposals=6)
    got = join_indexes(ta, tb, proposals=6)
    assert got == want and len(got) >= 100


def test_join_indexes_edges():
    cfg = HNSWConfig(dims=4)
    a = HNSWIndex.build(np.eye(4, dtype=np.float32), cfg, device="cpu")
    assert join_indexes(a, HNSWIndex(cfg, device="cpu")) == {}
    with pytest.raises(ValueError, match="dimensionality"):
        join_indexes(a, HNSWIndex(HNSWConfig(dims=5), device="cpu"))
