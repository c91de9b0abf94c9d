"""vss_tpu_torch.index.search against vss_tpu.index.search on the CPU.

Both packages search the same graph: the JAX package's host builder makes
it (1024 x 128, seed 0, the graph of `__graft_entry__.entry()`), and
`convert.graph_from_arrays` carries its arrays across. The port scores
every candidate with kernel K1's plain version; vss_tpu (Pallas off on
the CPU) with its XLA gather. The beam visits the same nodes in the same
order, so the result rows hold the same id sets, the loop counters are
equal, and distances agree within rtol 1e-5, atol 1e-4 (f32 sums in
another order). Ids are compared as sets per row because `_merge_sorted`
breaks exact ties by network position.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vss_tpu.index.search as jsearch
import vss_tpu_torch.index.search as tsearch
from vss_tpu.index.graph import HNSWConfig as JConfig
from vss_tpu.index.graph import HNSWGraph as JGraph
from vss_tpu.index.graph import empty_graph as jax_empty_graph
from vss_tpu.index.host_build import build_host_graph, host_graph_to_device
from vss_tpu_torch.convert import GRAPH_FIELDS, graph_from_arrays
from vss_tpu_torch.index.graph import HNSWConfig as TConfig

RTOL, ATOL = 1e-5, 1e-4
D = 128


def _arrays(graph) -> dict:
    return {f: np.asarray(getattr(graph, f)) for f in GRAPH_FIELDS}


@pytest.fixture(scope="module")
def built():
    cfg = JConfig(dims=D)
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((1024, D)).astype(np.float32)
    arrays = _arrays(host_graph_to_device(build_host_graph(vecs, cfg, seed=0)))
    q = rng.standard_normal((64, D)).astype(np.float32)
    return vecs, arrays, q


def _jax_graph(arrays) -> JGraph:
    return JGraph(**{f: jnp.asarray(a) for f, a in arrays.items()})


def _pivots(arrays):
    """The pivot sample HNSWIndex.pivots() takes: level >= 1 nodes, padded
    with -1 to a power of two."""
    idx = np.nonzero((arrays["levels"] >= 1) & (arrays["slot_to_rowid"] >= 0))[0]
    p = 1 << (idx.size - 1).bit_length()
    slots = np.full(p, -1, np.int32)
    slots[: idx.size] = idx
    vecs = arrays["vectors"][np.maximum(slots, 0)]
    return slots, vecs


def _run_both(arrays, q, metric="l2sq", storage="f32", pivots=False,
              filter_mask=None, rerank=None, **kw):
    jcfg = JConfig(dims=D, metric=metric, storage_dtype=storage)
    tcfg = TConfig(dims=D, metric=metric, storage_dtype=storage)
    jg = _jax_graph(arrays)
    tg = graph_from_arrays(arrays, "cpu")
    jkw, tkw = dict(kw), dict(kw)
    if pivots:
        slots, pvecs = _pivots(arrays)
        jkw.update(pivot_slots=jnp.asarray(slots), pivot_vecs=jnp.asarray(pvecs))
        tkw.update(pivot_slots=torch.from_numpy(slots), pivot_vecs=torch.from_numpy(pvecs))
    if filter_mask is not None:
        jkw["filter_mask"] = jnp.asarray(filter_mask)
        tkw["filter_mask"] = torch.from_numpy(filter_mask)
    if rerank is not None:
        jkw["rerank_tape"] = jnp.asarray(rerank)
        tkw["rerank_tape"] = torch.from_numpy(rerank)
    jd, ji, jst = jsearch.hnsw_search(jg, jcfg, jnp.asarray(q), with_stats=True, **jkw)
    td, ti, tst = tsearch.hnsw_search(tg, tcfg, torch.from_numpy(q), with_stats=True, **tkw)
    return (np.asarray(jd), np.asarray(ji), jst), (td.numpy(), ti.numpy(), tst)


def _check(j, t):
    jd, ji, jst = j
    td, ti, tst = t
    assert tst == jst
    np.testing.assert_array_equal(np.sort(ti, 1), np.sort(ji, 1))
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=RTOL, atol=ATOL)


def test_greedy_descent_matches_jax(built):
    _, arrays, q = built
    jcfg, tcfg = JConfig(dims=D), TConfig(dims=D)
    jg = _jax_graph(arrays)
    tg = graph_from_arrays(arrays, "cpu")
    top = int(arrays["max_level"])
    # per-query stop levels (0, 1, the top, above the top), and step caps
    stops = np.resize(np.array([0, 1, top, top + 1, 0, 2], np.int32), q.shape[0])
    for stop, max_iters in ((0, 0), (stops, 0), (0, 1), (stops, 2)):
        jc, jcd = jsearch.greedy_descent(jg, jcfg, jnp.asarray(q), stop_level=jnp.asarray(stop),
                                         max_iters=max_iters)
        tc, tcd = tsearch.greedy_descent(tg, tcfg, torch.from_numpy(q),
                                         stop_level=torch.as_tensor(stop), max_iters=max_iters)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(tcd.numpy(), np.asarray(jcd), rtol=RTOL, atol=ATOL)
    # the step caps stop the descent early
    full, _ = tsearch.greedy_descent(tg, tcfg, torch.from_numpy(q))
    one, _ = tsearch.greedy_descent(tg, tcfg, torch.from_numpy(q), max_iters=1)
    assert top >= 2 and not torch.equal(full, one)


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_pivot_seeds_match_jax(built, metric):
    _, arrays, q = built
    jcfg = JConfig(dims=D, metric=metric)
    tcfg = TConfig(dims=D, metric=metric)
    slots, pvecs = _pivots(arrays)
    jg = _jax_graph(arrays)
    js, jsd = jsearch.pivot_seeds(jg, jcfg, jnp.asarray(q), jnp.asarray(slots),
                                  jnp.asarray(pvecs), 4)
    ts, tsd = tsearch.pivot_seeds(graph_from_arrays(arrays, "cpu"), tcfg, torch.from_numpy(q),
                                  torch.from_numpy(slots), torch.from_numpy(pvecs), 4)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tsd.numpy(), np.asarray(jsd), rtol=RTOL, atol=ATOL)


def test_merge_sorted_matches_jax():
    rng = np.random.default_rng(3)
    a = np.sort(rng.random((5, 12)).astype(np.float32), 1)
    b = np.sort(rng.random((5, 7)).astype(np.float32), 1)
    ai = rng.integers(0, 99, (5, 12)).astype(np.int32)
    bi = rng.integers(0, 99, (5, 7)).astype(np.int32)
    jd, ji = jsearch._merge_sorted((jnp.asarray(a), jnp.asarray(ai)),
                                   (jnp.asarray(b), jnp.asarray(bi)), 12)
    td, ti = tsearch._merge_sorted((torch.from_numpy(a), torch.from_numpy(ai)),
                                   (torch.from_numpy(b), torch.from_numpy(bi)), 12)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_search_greedy_descent_single_pool(built):
    _, arrays, q = built
    j, t = _run_both(arrays, q, k=10, ef=64, assume_all_valid=True)
    _check(j, t)


@pytest.mark.parametrize("expand", [1, 2])
@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_search_pivot_seeds(built, expand, metric):
    _, arrays, q = built
    j, t = _run_both(arrays, q, metric=metric, pivots=True, k=10, ef=48,
                     expand=expand, assume_all_valid=True)
    _check(j, t)


def test_search_dual_pool_with_tombstones(built):
    _, arrays, q = built
    arrays = dict(arrays)
    valid = arrays["valid"].copy()
    valid[np.random.default_rng(5).choice(1024, 150, replace=False)] = False
    arrays["valid"] = valid
    j, t = _run_both(arrays, q, pivots=True, k=10, ef=64)
    _check(j, t)
    assert valid[t[1][t[1] >= 0]].all()


def test_search_filter_mask(built):
    _, arrays, q = built
    fm = np.zeros(arrays["valid"].shape[0], bool)
    fm[::3] = True
    j, t = _run_both(arrays, q, k=10, ef=64, filter_mask=fm, use_history=False)
    _check(j, t)
    assert fm[t[1][t[1] >= 0]].all()


def test_search_int8_tape_with_rerank(built):
    vecs, arrays, q = built
    scale = float(np.abs(vecs).max()) / 127.0
    arrays = dict(arrays)
    cap = arrays["vectors"].shape[0]
    scaled = np.zeros((cap, D), np.float32)
    scaled[: vecs.shape[0]] = vecs / scale
    arrays["vectors"] = np.clip(np.round(scaled), -127, 127).astype(np.int8)
    j, t = _run_both(arrays, q / scale, storage="int8", pivots=True, k=10, ef=64,
                     rerank=scaled, assume_all_valid=True)
    _check(j, t)


def test_search_empty_graph():
    cfg = JConfig(dims=16)
    arrays = _arrays(jax_empty_graph(cfg, 64))
    q = np.random.default_rng(0).standard_normal((3, 16)).astype(np.float32)
    td, ti = tsearch.hnsw_search(graph_from_arrays(arrays, "cpu"), TConfig(dims=16),
                                 torch.from_numpy(q), k=4)
    jd, ji = jsearch.hnsw_search(_jax_graph(arrays), cfg, jnp.asarray(q), k=4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti.numpy() == -1).all() and not np.isfinite(td.numpy()).any()


def test_search_rerank_nan_rows_depart_from_jax(built):
    """Where a rerank row holds a NaN, the JAX package keeps its NaN
    distance and its id, sorted after every +inf; the port scores it +inf
    with id -1 (the rerank_pool kernel's contract, and `rescore_topk`'s),
    in the place of the -1 ids at the end. Every other answer is the
    same."""
    vecs, arrays, q = built
    scale = float(np.abs(vecs).max()) / 127.0
    arrays = dict(arrays)
    cap = arrays["vectors"].shape[0]
    scaled = np.zeros((cap, D), np.float32)
    scaled[: vecs.shape[0]] = vecs / scale
    arrays["vectors"] = np.clip(np.round(scaled), -127, 127).astype(np.int8)
    kw = dict(storage="int8", pivots=True, k=64, ef=64, assume_all_valid=True)
    _, (_, ti, _) = _run_both(arrays, q / scale, rerank=scaled, **kw)
    nan_rows = np.unique(ti[:4, :3])
    scaled[nan_rows, 7] = np.nan
    (jd, ji, jst), (td, ti, tst) = _run_both(arrays, q / scale, rerank=scaled, **kw)
    assert tst == jst
    jnan = np.isnan(jd)
    assert jnan[:4].sum(1).min() >= 3 and (ji[jnan] >= 0).all()
    assert not np.isnan(td).any()
    # the JAX package's NaNs sit last, the port's +inf / -1 in their place
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_array_equal(ti[~fin], -1)
    assert np.isposinf(td[~fin]).all()
    np.testing.assert_array_equal(np.sort(np.where(fin, ti, -1), 1),
                                  np.sort(np.where(fin, ji, -1), 1))
    np.testing.assert_allclose(td[fin], jd[fin], rtol=RTOL, atol=ATOL)
