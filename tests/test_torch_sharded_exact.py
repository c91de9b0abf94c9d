"""The sharded bulk build (`vss_tpu_torch/parallel/sharded_build.py`) on
the CPU.

The four cases of `tests/test_sharded_exact.py` on the port (recall
against the port's exact oracle, with the reference's bars), and
cross-package parity: on integer-valued vectors every f32 product and
distance is exact in both packages and both break ties by the lower
position, so each shard built with `method="exact"` must equal the JAX
package's array for array (`adj0`, `upper_adj`, `levels`, `upper_row`,
`valid`, `slot_to_rowid`, `entry`, `max_level`, `count`, the tape and the
side tape), outside the scatter sinks (slot `capacity - 1`, row
`upper_capacity - 1`, which the JAX package's pad rows write and nothing
reads). The last case pins fault C3 (ROADMAP): on bulk-built shards
the JAX package's sharded search, seeded by greedy descent, loses recall
that the port's, seeded from each shard's pivots, keeps.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vss_tpu.index.graph import HNSWConfig as JConfig
from vss_tpu.parallel import ShardedHNSWIndex as JSharded
from vss_tpu.parallel import make_mesh as jmesh
from vss_tpu_torch.index.dense import HNSWIndex
from vss_tpu_torch.index.graph import HNSWConfig
from vss_tpu_torch.ops.topk import bruteforce_topk
from vss_tpu_torch.parallel import ShardedHNSWIndex, make_mesh

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh(n):
    return make_mesh(n, device=CPU)


def _truth(q, vecs, k):
    return bruteforce_topk(torch.from_numpy(q), torch.from_numpy(vecs), k, "l2sq",
                           device=CPU)[1].numpy()


def _recall(rows, gt, k=10):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / k for a, b in zip(rows, gt)])


def _index_recall(idx, vecs, q, k=10, ef=64):
    _, rows = idx.search(q, k=k, ef=ef)
    return _recall(rows.numpy(), _truth(q, vecs, k), k)


def test_sharded_exact_build_recall_parity():
    rng = np.random.default_rng(11)
    n, d = 4096, 32
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    q = vecs[rng.integers(0, n, 64)] + rng.normal(0, 0.05, (64, d)).astype(np.float32)
    cfg = HNSWConfig(dims=d, metric="l2sq")
    sh = ShardedHNSWIndex.build(vecs, cfg, mesh(4), method="exact")
    assert sh.count == n
    rec_sh = _index_recall(sh, vecs, q)
    single = HNSWIndex.build(vecs, cfg, method="exact", device=CPU)
    rec_1 = _index_recall(single, vecs, q)
    # the merge of 4 independent shards' top-k: at least the single
    # graph's recall minus small slack
    assert rec_sh >= rec_1 - 0.02, (rec_sh, rec_1)
    assert rec_sh >= 0.9, rec_sh


def test_sharded_exact_build_then_crud():
    rng = np.random.default_rng(3)
    n, d = 1024, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    sh = ShardedHNSWIndex.build(vecs, HNSWConfig(dims=d, metric="l2sq"), mesh(4),
                                method="exact")
    # insert on top of an exact-built index uses the wave path
    extra = rng.normal(size=(32, d)).astype(np.float32)
    sh.insert(extra, rowids=np.arange(n, n + 32))
    assert sh.count == n + 32
    assert sh.delete(list(range(0, 64))) == 64
    _, rows = sh.search(vecs[100:108], k=5, ef=48)
    rows = rows.numpy()
    assert (rows[rows >= 0] >= 64).all()
    # self-match should survive for non-deleted queries
    assert sum(100 + i in set(r.tolist()) for i, r in enumerate(rows)) >= 7


def test_sharded_exact_uneven_shards():
    # n not divisible by S: the last shards get one fewer row
    rng = np.random.default_rng(5)
    n, d = 1001, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    sh = ShardedHNSWIndex.build(vecs, HNSWConfig(dims=d, metric="l2sq"), mesh(4),
                                method="exact")
    assert sh.count == n and sh.next_slot == [251, 250, 250, 250]
    _, rows = sh.search(vecs[:16], k=1, ef=32)
    assert (rows.numpy()[:, 0] == np.arange(16)).mean() >= 0.95


def test_sharded_exact_int8_storage():
    rng = np.random.default_rng(9)
    n, d = 2048, 24
    vecs = rng.integers(0, 200, (n, d)).astype(np.float32)
    sh = ShardedHNSWIndex.build(vecs, HNSWConfig(dims=d, metric="l2sq", storage_dtype="int8"),
                                mesh(4), method="exact")
    q = vecs[rng.integers(0, n, 32)].astype(np.float32)
    assert _index_recall(sh, vecs, q, k=10, ef=64) >= 0.85


@pytest.mark.parametrize("storage,metric,n", [("f32", "l2sq", 1001), ("int8", "l2sq", 1024),
                                              ("f32", "cosine", 768)])
def test_exact_built_shards_equal_jax(storage, metric, n):
    rng = np.random.default_rng(17)
    d = 16
    vecs = rng.integers(-12, 13, (n, d)).astype(np.float32)
    if storage == "int8":
        vecs *= 20.0
        vecs[0, 0] = 254.0  # scale exactly 2 in both packages
    kw = dict(dims=d, m=6, metric=metric, storage_dtype=storage)
    j = JSharded.build(vecs, JConfig(**kw), jmesh(4), method="exact", seed=3)
    t = ShardedHNSWIndex.build(vecs, HNSWConfig(**kw), mesh(4), method="exact", seed=3)
    assert (j.next_slot, j.upper_used, j.vector_scale) == (t.next_slot, t.upper_used,
                                                           t.vector_scale)
    assert j.rowid_to_loc == t.rowid_to_loc
    for s in range(4):
        tg = t.graphs[s]
        cap, ucap = tg.capacity, tg.upper_capacity
        for f in dataclasses.fields(j.graphs):
            rows = {"adj0": cap - 1, "upper_adj": ucap - 1}.get(f.name)
            want = np.asarray(getattr(j.graphs, f.name))[s]
            got = getattr(tg, f.name).numpy()
            if rows is not None:
                got, want = got[:rows], want[:rows]
            np.testing.assert_array_equal(got, want, err_msg=f"{f.name} of shard {s}")
        if storage == "int8":
            np.testing.assert_array_equal(t.rerank_tapes[s].numpy(),
                                          np.asarray(j.rerank_tapes)[s])


def test_pivot_seeding_diverges_from_jax_on_bulk_built_shards():
    """Fault C3: on bulk-built shards of a clustered corpus (upper levels
    that join no clusters), the JAX package's sharded search, seeded by
    greedy descent, misses true neighbours that the port's, seeded from
    each shard's pivots, finds. 20,000 SIFT-like rows (the generator of
    `bench.py`: clusters in [0, 255]^128), 4 shards, int8, ef 64."""
    rng = np.random.default_rng(0)
    n, d, nq = 20000, 128, 256
    centers = rng.uniform(0, 255, (max(64, n // 2000), d))
    vecs = np.clip(centers[rng.integers(0, len(centers), n)] + rng.normal(0, 25, (n, d)), 0, 255)
    q = np.clip(centers[rng.integers(0, len(centers), nq)] + rng.normal(0, 25, (nq, d)), 0, 255)
    vecs, q = vecs.astype(np.float32), q.astype(np.float32)
    kw = dict(dims=d, storage_dtype="int8")
    j = JSharded.build(vecs, JConfig(**kw), jmesh(4))
    t = ShardedHNSWIndex.build(vecs, HNSWConfig(**kw), mesh(4))
    truth = bruteforce_topk(torch.from_numpy(q), torch.from_numpy(vecs), 10, "l2sq",
                            device="cpu")[1].numpy()

    def recall(rows):
        return np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                        for a, b in zip(np.asarray(rows), truth)])

    r_port = recall(t.search(q, k=10, ef=64)[1].numpy())
    r_jax = recall(j.search(q, k=10, ef=64)[1])
    assert r_port >= 0.99, r_port
    assert r_jax < r_port - 0.03, (r_jax, r_port)
