"""vss_tpu_torch.HNSWIndex against vss_tpu.HNSWIndex on the CPU.

Both packages build the same 2000-row int8 index with the native C++
builder (the same source; `method="auto"` at n <= 8192 runs it on one
thread, so the build is deterministic) and must hold equal graphs. Then
`search` and `scan_search` must return the same rowids, with distances
within rtol 1e-5, atol 1e-4, before and after tombstoning 10% of the
rows. The data are integer-valued like SIFT's byte descriptors, in
[0, 127] so the int8 scale is exactly 1: every f32 dot product and norm
is then exact, and the two packages' different summation orders cannot
move the l2sq dot-product identity's cancellation error across the
tolerance.
"""
import numpy as np
import pytest
import torch

import vss_tpu.index.dense as jdense
import vss_tpu_torch.index.dense as tdense
from vss_tpu.index.graph import HNSWConfig as JConfig
from vss_tpu_torch import HNSWIndex
from vss_tpu_torch.convert import GRAPH_FIELDS, index_from_state
from vss_tpu_torch.index.graph import HNSWConfig as TConfig
from vss_tpu_torch.ops import bruteforce_topk, scan_topk

RTOL, ATOL = 1e-5, 1e-4
N, D, K = 2000, 32, 10


def _data():
    rng = np.random.default_rng(0)
    centers = rng.uniform(0, 127, (16, D))
    vecs = np.clip(centers[rng.integers(0, 16, N)] + rng.normal(0, 12, (N, D)), 0, 127)
    q = np.clip(centers[rng.integers(0, 16, 24)] + rng.normal(0, 12, (24, D)), 0, 127)
    return np.round(vecs).astype(np.float32), np.round(q).astype(np.float32)


@pytest.fixture(scope="module", params=["l2sq", "cosine"])
def pair(request):
    vecs, q = _data()
    metric = request.param
    jidx = jdense.HNSWIndex.build(
        vecs, JConfig(dims=D, metric=metric, storage_dtype="int8"), method="auto")
    tidx = tdense.HNSWIndex.build(
        vecs, TConfig(dims=D, metric=metric, storage_dtype="int8"), method="auto",
        device="cpu")
    return jidx, tidx, q


def _same(j, t):
    jd, jr = (np.asarray(a) for a in j)
    td, tr = (a.numpy() for a in t)
    np.testing.assert_array_equal(np.sort(tr, 1), np.sort(jr, 1))
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=RTOL, atol=ATOL)


def test_native_build_gives_equal_graph(pair):
    jidx, tidx, _ = pair
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(
            getattr(tidx.graph, f).numpy(), np.asarray(getattr(jidx.graph, f)), err_msg=f)
    assert tidx.vector_scale == jidx.vector_scale == 1.0
    np.testing.assert_array_equal(tidx.rerank_tape.numpy(), np.asarray(jidx.rerank_tape))
    assert (tidx.count, tidx.capacity, tidx.dims) == (jidx.count, jidx.capacity, jidx.dims)


@pytest.mark.parametrize("path", ["search", "scan_search"])
def test_serving_paths_match_jax(pair, path):
    jidx, tidx, q = pair
    kw = {"ef": 64} if path == "search" else {}
    _same(getattr(jidx, path)(q, K, **kw), getattr(tidx, path)(q, K, **kw))


@pytest.mark.parametrize("path", ["search", "scan_search"])
def test_serving_paths_match_jax_after_delete(pair, path):
    jidx, tidx, q = pair
    gone = np.random.default_rng(1).choice(N, N // 10, replace=False)
    # the index fixture is shared by the module: delete on copies
    jidx = jidx.clone()
    tidx = _torch_copy(tidx)
    assert jidx.delete(gone) == tidx.delete(gone) == N // 10
    assert tidx.count == jidx.count == N - N // 10
    kw = {"ef": 64} if path == "search" else {}
    t = getattr(tidx, path)(q, K, **kw)
    _same(getattr(jidx, path)(q, K, **kw), t)
    assert not np.isin(t[1].numpy(), gone).any()


def _torch_copy(idx):
    """The port's index rebuilt from its own state through `convert`."""
    arrays = {f: getattr(idx.graph, f).numpy() for f in GRAPH_FIELDS}
    return index_from_state(
        idx.config, arrays, vector_scale=idx.vector_scale,
        rerank_tape=idx.rerank_tape.numpy(), rowid_to_slot=idx.rowid_to_slot,
        next_slot=idx.next_slot, deleted_count=idx.deleted_count,
        free_slots=idx.free_slots, upper_used=idx.upper_used, device="cpu",
    )


def test_convert_carries_jax_index_across(pair):
    jidx, _, q = pair
    arrays = {f: np.asarray(getattr(jidx.graph, f)) for f in GRAPH_FIELDS}
    cfg = jidx.config
    tidx = index_from_state(
        TConfig(dims=cfg.dims, metric=cfg.metric, storage_dtype=cfg.storage_dtype),
        arrays, vector_scale=jidx.vector_scale, rerank_tape=np.asarray(jidx.rerank_tape),
        rowid_to_slot=jidx.rowid_to_slot, next_slot=jidx.next_slot, device="cpu",
    )
    _same(jidx.search(q, K, ef=64), tidx.search(q, K, ef=64))


def test_entry_points_need_a_gpu_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = TConfig(dims=8)
    x = torch.zeros((4, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HNSWIndex(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HNSWIndex.build(np.zeros((4, 8), np.float32), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bruteforce_topk(x, x, 1, "l2sq")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scan_topk(x, x, 1, "l2sq")


def test_build_methods_exact_and_auto_build_above_8192_rows():
    vecs = np.zeros((16, 8), np.float32)
    with pytest.raises(ValueError, match="unknown build method"):
        HNSWIndex.build(vecs, TConfig(dims=8), method="bulk", device="cpu")
    # the wave builder is ported
    assert HNSWIndex.build(vecs, TConfig(dims=8), method="wave", device="cpu").count == 16
    # 'auto' takes the bulk builder above 8,192 rows, and 'exact' is it
    big = np.random.default_rng(5).normal(size=(9000, 8)).astype(np.float32)
    for method in ("exact", "auto"):
        idx = HNSWIndex.build(big, TConfig(dims=8), method=method, device="cpu")
        assert idx.count == 9000 and int(idx.graph.count) == 9000
        assert idx.build_stats["mode"] == "exact"
        _, rows = idx.search(big[:8], 1, ef=32)
        assert (rows[:, 0].numpy() == np.arange(8)).all()


def test_convert_carries_write_path_state(pair):
    jidx, _, _ = pair
    jidx = jidx.clone()
    jidx.insert(np.full((2, D), 200.0, np.float32), [N, N + 1])  # beyond the int8 scale
    arrays = {f: np.asarray(getattr(jidx.graph, f)) for f in GRAPH_FIELDS}
    cfg = jidx.config
    tidx = index_from_state(
        TConfig(dims=cfg.dims, metric=cfg.metric, storage_dtype=cfg.storage_dtype),
        arrays, vector_scale=jidx.vector_scale, rerank_tape=np.asarray(jidx.rerank_tape),
        rowid_to_slot=jidx.rowid_to_slot, next_slot=jidx.next_slot,
        upper_used=jidx.upper_used, scale_max_abs=jidx.scale_max_abs,
        scale_overflow=jidx.scale_overflow, insert_seed=jidx._insert_seed,
        dirty=jidx.dirty, device="cpu",
    )
    assert (tidx.scale_max_abs, tidx.scale_overflow, tidx._insert_seed, tidx.dirty) == (
        200.0, 2, N + 2, True)
    # both go on from the carried state alike: the next insert draws the
    # same levels and compact() requantizes to the same scale
    more = np.full((3, D), 7.0, np.float32)
    for idx in (jidx, tidx):
        idx.insert(more, [N + 5, N + 6, N + 7])
        idx.compact()
    assert tidx.vector_scale == jidx.vector_scale == 200.0 / 127.0
    assert tidx.upper_used == jidx.upper_used and tidx.count == jidx.count
    np.testing.assert_array_equal(tidx.graph.levels.numpy(), np.asarray(jidx.graph.levels))
    np.testing.assert_array_equal(tidx.graph.vectors.numpy(), np.asarray(jidx.graph.vectors))
