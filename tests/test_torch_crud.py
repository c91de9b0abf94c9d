"""CRUD semantics of vss_tpu_torch.HNSWIndex on the CPU: insert,
tombstone delete, slot recycling, compaction, layout, stats.

The first part ports the index-level tests of `tests/test_crud.py` to the
port. The second runs one scripted history through both packages step by
step: the same numpy inputs, and after every step the same bookkeeping,
the same `stats()` and the same search results. The history's vectors are
small integers, so every f32 product, norm and distance is exact in both
packages whatever the order of their sums: the two indexes must then
make the same decisions, and rowids are compared for equality (as sets
per row: exact ties in the result pool are ordered by network position)
with distances within rtol 1e-5, atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vss_tpu.index.dense as jdense
from vss_tpu.index.graph import HNSWConfig as JConfig
from vss_tpu_torch import HNSWConfig, HNSWIndex
from vss_tpu_torch.ops import bruteforce_topk

RTOL, ATOL = 1e-5, 1e-5


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


def recall(ids, true_ids):
    hits = sum(
        len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist()))
        for a, b in zip(ids, true_ids)
    )
    return hits / true_ids[true_ids >= 0].size


def _search(idx, q, k, **kw):
    d, rows = idx.search(q, k=k, **kw)
    return d.numpy(), rows.numpy()


def _truth(q, x, k):
    _, bi = bruteforce_topk(torch.from_numpy(q), torch.from_numpy(x), k, "l2sq", device="cpu")
    return bi.numpy()


@pytest.fixture
def small_index(rng):
    vecs = rng.standard_normal((500, 16)).astype(np.float32)
    idx = HNSWIndex.build(vecs, HNSWConfig(dims=16), wave_size=128, device="cpu")
    return idx, vecs


def test_incremental_insert_matches_bulk(rng):
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    idx = HNSWIndex(HNSWConfig(dims=16), device="cpu")
    for s in range(0, 300, 50):
        idx.insert(vecs[s : s + 50], np.arange(s, s + 50))
    assert idx.count == 300 and idx.dirty
    q = rng.standard_normal((20, 16)).astype(np.float32)
    _, rows = _search(idx, q, 5)
    assert recall(rows, _truth(q, vecs, 5)) >= 0.9


def test_delete_excludes_rows(small_index):
    idx, vecs = small_index
    q = vecs[7][None, :]
    assert int(_search(idx, q, 1)[1][0, 0]) == 7
    assert idx.delete([7]) == 1
    assert idx.count == 499
    assert 7 not in _search(idx, q, 5)[1]


def test_delete_missing_rowid(small_index):
    idx, _ = small_index
    assert idx.delete([999999]) == 0


def test_insert_recycles_tombstoned_slots(small_index, rng):
    idx, _ = small_index
    before_next = idx.next_slot
    idx.delete([1, 2, 3])
    assert idx.deleted_count == 3
    nv = rng.standard_normal((3, 16)).astype(np.float32)
    idx.insert(nv, [1001, 1002, 1003])
    assert idx.next_slot == before_next  # no new slots claimed
    assert idx.deleted_count == 0
    # the last tombstoned slot is recycled first
    assert [idx.rowid_to_slot[r] for r in (1001, 1002, 1003)] == [3, 2, 1]
    assert sorted(_search(idx, nv, 1)[1][:, 0].tolist()) == [1001, 1002, 1003]


def test_duplicate_rowid_rejected(small_index, rng):
    idx, _ = small_index
    with pytest.raises(ValueError, match="duplicate rowid"):
        idx.insert(rng.standard_normal((1, 16)).astype(np.float32), [7])


def test_compact_removes_tombstones(small_index, rng):
    idx, vecs = small_index
    dead = list(range(0, 100))
    idx.delete(dead)
    idx.compact()
    assert idx.deleted_count == 0
    assert idx.next_slot == 400
    assert idx.count == 400
    assert idx.free_slots == []
    q = rng.standard_normal((20, 16)).astype(np.float32)
    _, rows = _search(idx, q, 5)
    bi = _truth(q, vecs[100:], 5)
    true_rows = np.where(bi >= 0, bi + 100, -1)
    assert recall(rows, true_rows) >= 0.85
    # deleted rows never reappear
    assert not set(rows.ravel().tolist()) & set(dead)
    # the permuted tape holds the kept rows and a zero tail
    assert torch.equal(idx.graph.vectors[:400], torch.from_numpy(vecs[100:]))
    assert not idx.graph.vectors[400:].any()


def test_compact_noop_when_clean(small_index):
    idx, _ = small_index
    before = idx.graph.adj0.clone()
    graph = idx.graph
    idx.compact()
    assert idx.graph is graph
    assert torch.equal(idx.graph.adj0, before)


def test_capacity_growth(rng):
    idx = HNSWIndex(HNSWConfig(dims=8), capacity=64, device="cpu")
    vecs = rng.standard_normal((500, 8)).astype(np.float32)
    idx.insert(vecs, np.arange(500))
    assert idx.capacity >= 500 + 8
    assert idx.usable_capacity == idx.capacity - 8
    assert _search(idx, vecs[:5], 1)[1][:, 0].tolist() == [0, 1, 2, 3, 4]
    np.testing.assert_array_equal(idx.slot_rowid_array()[:500], np.arange(500))


def test_stats(small_index):
    idx, _ = small_index
    st = idx.stats()
    assert st["count"] == 500
    assert st["dimensions"] == 16
    assert st["connectivity"] == 16
    assert st["connectivity_base"] == 32
    assert st["num_levels"] >= 1
    assert st["levels"][0]["nodes"] == 500
    assert 0 < st["levels"][0]["edges"] <= st["levels"][0]["max_edges"]


def test_optimize_layout_preserves_results(small_index, rng):
    idx, _ = small_index
    q = rng.standard_normal((30, 16)).astype(np.float32)
    d1, r1 = _search(idx, q, 5, ef=96)
    idx.optimize_layout(n_clusters=16)
    d2, r2 = _search(idx, q, 5, ef=96)
    # same database, permuted layout: equivalent sets, identical distances
    np.testing.assert_allclose(np.sort(d1, axis=1), np.sort(d2, axis=1), atol=1e-5)
    overlap = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(r1, r2)) / r1.size
    assert overlap >= 0.95
    # CRUD still works after relayout
    idx.delete([int(r2[0, 0])])
    idx.insert(rng.standard_normal((1, 16)).astype(np.float32), [77777])
    assert _search(idx, q, 5, ef=96)[1].shape == (30, 5)


def test_vacuum_and_merge_parity(small_index):
    idx, _ = small_index
    idx.vacuum()  # no-op
    with pytest.raises(NotImplementedError, match="MergeIndexes"):
        idx.merge(idx)
    assert HNSWIndex.supports_filter_pushdown


def test_rowid_int32_overflow_rejected(rng):
    vecs = rng.standard_normal((4, 8)).astype(np.float32)
    cfg = HNSWConfig(dims=8)
    with pytest.raises(ValueError, match="int32"):
        HNSWIndex.build(vecs, cfg, rowids=np.asarray([0, 1, 2, 2**31]), device="cpu")
    idx = HNSWIndex.build(vecs, cfg, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        idx.insert(vecs[:1], [2**40])


def test_insert_publishes_a_new_graph_and_keeps_the_old(small_index, rng):
    """A search that took its snapshot of `idx.graph` before an insert,
    a delete or a rename still sees the tensors as they were."""
    idx, _ = small_index
    old = idx.graph
    copies = {f: getattr(old, f).clone() for f in ("vectors", "adj0", "valid", "slot_to_rowid")}
    idx.insert(rng.standard_normal((5, 16)).astype(np.float32), np.arange(900, 905))
    idx.delete([0])
    idx.rename(1, 5001)
    assert idx.graph is not old
    for f, c in copies.items():
        assert torch.equal(getattr(old, f), c), f


# ---------------------------------------------------------------------
# one scripted history through both packages

D = 16


def _ints(rng, n, lo=-8, hi=9):
    return rng.integers(lo, hi, (n, D)).astype(np.float32)


def _state(idx):
    return {
        "count": idx.count, "next_slot": idx.next_slot,
        "free_slots": list(idx.free_slots), "deleted_count": idx.deleted_count,
        "upper_used": idx.upper_used, "vector_scale": idx.vector_scale,
        "scale_overflow": idx.scale_overflow, "scale_max_abs": idx.scale_max_abs,
        "capacity": idx.capacity, "dirty": idx.dirty,
        "rowid_to_slot": dict(idx.rowid_to_slot), "stats": idx.stats(),
    }


def _agree(step, jidx, tidx, q):
    js, ts = _state(jidx), _state(tidx)
    for key in js:
        assert ts[key] == js[key], f"after {step}: {key}"
    jd, jr = (np.asarray(a) for a in jidx.search(q, k=5, ef=48))
    td, tr = (a.numpy() for a in tidx.search(q, k=5, ef=48))
    np.testing.assert_array_equal(np.sort(tr, 1), np.sort(jr, 1), err_msg=f"after {step}")
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=RTOL, atol=ATOL, err_msg=f"after {step}")


def _both(step, jidx, tidx, q, fn):
    """Apply one step to both indexes; their return values must agree."""
    jr, tr = fn(jidx), fn(tidx)
    assert jr == tr, f"{step}: returned {jr} and {tr}"
    _agree(step, jidx, tidx, q)


def test_scripted_history_matches_jax():
    rng = np.random.default_rng(7)
    vecs = _ints(rng, 500)
    q = _ints(rng, 20) + 0.5
    kw = dict(dims=D, ef_construction=32)
    jidx = jdense.HNSWIndex.build(vecs, JConfig(**kw), method="wave", wave_size=128)
    tidx = HNSWIndex.build(vecs, HNSWConfig(**kw), method="wave", wave_size=128, device="cpu")
    _agree("wave build", jidx, tidx, q)

    gone = rng.choice(500, 30, replace=False).tolist()
    _both("delete", jidx, tidx, q, lambda i: i.delete(gone + [10**6]))
    new = _ints(rng, 10)
    _both("insert that recycles", jidx, tidx, q, lambda i: i.insert(new, np.arange(600, 610)))
    assert tidx.next_slot == 500 and tidx.deleted_count == 20
    more = _ints(rng, 100)
    cap = tidx.capacity
    _both("insert that grows", jidx, tidx, q, lambda i: i.insert(more, np.arange(700, 800)))
    assert tidx.capacity == 2 * cap
    _both("rename", jidx, tidx, q, lambda i: (i.rename(5 if 5 not in gone else 700, 9005),
                                              i.rename(123456, 1)))
    _both("compact", jidx, tidx, q, lambda i: i.compact())
    assert tidx.deleted_count == 0 and tidx.next_slot == tidx.count == 580
    _both("optimize_layout", jidx, tidx, q, lambda i: i.optimize_layout(n_clusters=16, seed=3))
    for f in ("adj0", "levels", "valid", "slot_to_rowid", "upper_row"):
        np.testing.assert_array_equal(
            getattr(tidx.graph, f).numpy()[:-1], np.asarray(getattr(jidx.graph, f))[:-1], err_msg=f)


def test_scripted_int8_history_matches_jax():
    """int8: inserts beyond the build-time scale are counted, clip in the
    tape, and compact() requantizes from the f32 rerank tape."""
    rng = np.random.default_rng(8)
    vecs = _ints(rng, 300, -100, 101)
    vecs[0, 0] = 127.0  # the scale is exactly 1
    q = _ints(rng, 20, -100, 101)
    kw = dict(dims=D, ef_construction=32, storage_dtype="int8")
    jidx = jdense.HNSWIndex.build(vecs, JConfig(**kw), method="wave", wave_size=128)
    tidx = HNSWIndex.build(vecs, HNSWConfig(**kw), method="wave", wave_size=128, device="cpu")
    assert tidx.vector_scale == 1.0 and tidx.scale_max_abs == 127.0
    _agree("int8 wave build", jidx, tidx, q)
    big = _ints(rng, 16, -100, 101)
    big[:5] *= 2.0
    big[0, 0] = 254.0
    _both("insert beyond the scale", jidx, tidx, q, lambda i: i.insert(big, np.arange(400, 416)))
    assert tidx.scale_overflow >= 1 and tidx.stats()["quantization"]["scale_drift"]
    assert int(tidx.graph.vectors.max()) == 127  # clipped in the tape
    _both("delete", jidx, tidx, q, lambda i: i.delete([1, 2, 3]))
    _both("compact requantizes", jidx, tidx, q, lambda i: i.compact())
    assert tidx.vector_scale == 2.0 and tidx.scale_overflow == 0
    np.testing.assert_array_equal(tidx.graph.vectors.numpy(), np.asarray(jidx.graph.vectors))
    np.testing.assert_array_equal(tidx.rerank_tape.numpy(), np.asarray(jidx.rerank_tape))
    _both("compact again", jidx, tidx, q, lambda i: i.compact())
