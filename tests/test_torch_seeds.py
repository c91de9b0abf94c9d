"""The port's scored pivot seeding (`scored_pivot_seeds`) against the JAX
package's route on the CPU, and the pivot caches that feed it.

`vss_tpu`'s `hnsw_search` seeds its beam by `pivot_seeds` (the [B, P]
product, the metric epilogue, the padding mask, `lax.top_k`, the slot
map) and scores each seed by `gathered_distances` over the gathered rows
(`vss_tpu/index/search.py:451-526`). The port does both in
`scored_pivot_seeds`: on CUDA tensors the product and one launch of the
`pivot_seeds` kernel (held to its route in
`test_torch_seeds_emulated.py` and on the card), on CPU tensors its plain
version, which runs here. Both packages search the graph of
`test_torch_search.py` (the JAX host builder, 1024 x 128, seed 0), with
its tape in f32, int8 and bf16. Seeds must be equal (the values are
real, so no two pivots tie); distances agree within 1e-5 of the
magnitude of the terms (l2sq: max |q|^2 + max |x|^2; ip: max |q| max |x|;
cosine: 1), the two sum in another order.

The pivot caches (`HNSWIndex.pivots`, the sharded index's per-shard
cache, both through `dense.pivot_rows`) hold the pivots' f32 rows and
squared norms once per pivot sample; searches and insert waves that take
them must equal those that do not, bit for bit.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vss_tpu.index.search as jsearch
import vss_tpu_torch.index.build as build_mod
import vss_tpu_torch.index.search as tsearch
from vss_tpu.index.graph import HNSWConfig as JConfig
from vss_tpu.index.graph import HNSWGraph as JGraph
from vss_tpu.index.host_build import build_host_graph, host_graph_to_device
from vss_tpu.ops.distance import gathered_distances as j_gathered_distances
from vss_tpu_torch import HNSWIndex
from vss_tpu_torch.convert import GRAPH_FIELDS, graph_from_arrays
from vss_tpu_torch.index.dense import graph_pivots, pivot_rows
from vss_tpu_torch.index.graph import HNSWConfig as TConfig

D = 128
REL_TOL = 1e-5


@pytest.fixture(scope="module")
def built():
    """The graph's arrays, its queries and its pivot sample (level >= 1
    nodes padded with -1 to a power of two, as `graph_pivots` takes them)."""
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((1024, D)).astype(np.float32)
    g = host_graph_to_device(build_host_graph(vecs, JConfig(dims=D), seed=0))
    arrays = {f: np.asarray(getattr(g, f)) for f in GRAPH_FIELDS}
    q = rng.standard_normal((48, D)).astype(np.float32)
    idx = np.nonzero((arrays["levels"] >= 1) & (arrays["slot_to_rowid"] >= 0))[0]
    slots = np.full(1 << (idx.size - 1).bit_length(), -1, np.int32)
    slots[: idx.size] = idx
    return arrays, q, slots


def _with_tape(arrays, q, storage):
    """The arrays with the tape in `storage` (int8: the rows scaled to
    +-127 and rounded, the queries scaled alike) and the queries."""
    arrays = dict(arrays)
    x = arrays["vectors"]
    if storage == "int8":
        scale = float(np.abs(x).max()) / 127.0
        arrays["vectors"] = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
        q = q / scale
    return arrays, q.astype(np.float32)


def _tape_jax(arrays, storage):
    j = {f: jnp.asarray(a) for f, a in arrays.items()}
    if storage == "bf16":
        j["vectors"] = j["vectors"].astype(jnp.bfloat16)
    return JGraph(**j)


def _tape_torch(arrays, storage):
    g = graph_from_arrays(arrays, "cpu")
    if storage == "bf16":
        g.vectors = g.vectors.to(torch.bfloat16)
    return g


def _scale(q, x, metric) -> float:
    if metric == "cosine":
        return 1.0
    qm = float(np.abs(q).max()) if metric == "ip" else float((q.astype(np.float64) ** 2)
                                                              .sum(1).max())
    xm = float(np.abs(x).max()) if metric == "ip" else float((x.astype(np.float64) ** 2)
                                                              .sum(1).max())
    return qm * xm if metric == "ip" else qm + xm


def _jax_route(jg, cfg, q, slots, n_seeds):
    """`vss_tpu`'s seeding as its `hnsw_search` runs it: `pivot_seeds`,
    then each seed scored from its gathered row (`gathered_distances` with
    the tape's norms), +inf for a -1 seed."""
    qj = jnp.asarray(q)
    q_norms = jnp.sum(qj * qj, axis=-1)
    pvecs = jg.vectors[jnp.maximum(jnp.asarray(slots), 0)]
    seeds, _ = jsearch.pivot_seeds(jg, cfg, qj, jnp.asarray(slots), pvecs, n_seeds, q_norms)
    xv = jg.vectors.astype(jnp.float32)
    x_norms = jnp.sum(xv * xv, axis=-1)
    seed_d = j_gathered_distances(qj, jsearch._gather_vectors(jg.vectors, seeds), cfg.metric,
                                  jsearch._gathered_norms(x_norms, seeds), q_norms)
    seed_d = jnp.where(seeds >= 0, seed_d, jnp.inf)
    return np.asarray(seeds), np.asarray(seed_d)


@pytest.mark.parametrize("n_seeds", [1, 4, 16])
@pytest.mark.parametrize("storage", ["f32", "int8", "bf16"])
@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_scored_pivot_seeds_match_jax(built, metric, storage, n_seeds):
    arrays, q0, slots = built
    arrays, q = _with_tape(arrays, q0, storage)
    jg, tg = _tape_jax(arrays, storage), _tape_torch(arrays, storage)
    js, jd = _jax_route(jg, JConfig(dims=D, metric=metric), q, slots, n_seeds)
    tslots = torch.from_numpy(slots)
    pv = tg.vectors[tslots.clamp(min=0).long()]
    tq = torch.from_numpy(q)
    ts, td = tsearch.scored_pivot_seeds(tg, TConfig(dims=D, metric=metric), tq, tslots, pv,
                                        n_seeds, (tq * tq).sum(-1))
    assert ts.dtype == torch.int32 and td.dtype == torch.float32
    assert ts.shape == td.shape == (q.shape[0], n_seeds)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(np.isfinite(td.numpy()), np.isfinite(jd))
    x = tg.vectors.float().numpy()
    np.testing.assert_allclose(td.numpy(), jd, rtol=0,
                               atol=REL_TOL * _scale(q, x, metric))


def test_scored_pivot_seeds_padding_and_nan(built):
    """Every slot -1: every seed -1 at +inf; a NaN query under l2sq: its
    seeds -1 at +inf in both packages; P below n_seeds: P seeds."""
    arrays, q0, slots = built
    arrays, q = _with_tape(arrays, q0, "f32")
    q[3, 5] = np.nan
    jg, tg = _tape_jax(arrays, "f32"), _tape_torch(arrays, "f32")
    cfg_j, cfg_t = JConfig(dims=D), TConfig(dims=D)
    tq = torch.from_numpy(q)
    for s, n in ((np.full_like(slots, -1), 4), (slots, 4), (slots[:3], 8)):
        js, jd = _jax_route(jg, cfg_j, q, s, n)
        ts_ = torch.from_numpy(np.ascontiguousarray(s))
        ts, td = tsearch.scored_pivot_seeds(tg, cfg_t, tq, ts_,
                                            tg.vectors[ts_.clamp(min=0).long()], n,
                                            (tq * tq).sum(-1))
        np.testing.assert_array_equal(ts.numpy(), js)
        np.testing.assert_array_equal(np.isfinite(td.numpy()), np.isfinite(jd))
        assert (ts[3] == -1).all() and torch.isinf(td[3]).all()
    assert ts.shape == (q.shape[0], 3)


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_hnsw_search_with_cached_pivots_matches_jax(built, metric, storage):
    """`hnsw_search` seeded from the cache's f32 rows and norms
    (`pivot_rows`) against `vss_tpu`'s from the tape's rows: the same id
    sets and distances within the tolerance; and against the port seeded
    from the tape's rows without norms, bit for bit."""
    arrays, q0, slots = built
    arrays, q = _with_tape(arrays, q0, storage)
    jg, tg = _tape_jax(arrays, storage), _tape_torch(arrays, storage)
    kw = dict(k=10, ef=48, with_stats=True, assume_all_valid=True)
    pvecs = arrays["vectors"][np.maximum(slots, 0)]
    jd, ji, jst = jsearch.hnsw_search(jg, JConfig(dims=D, metric=metric, storage_dtype=storage),
                                      jnp.asarray(q), pivot_slots=jnp.asarray(slots),
                                      pivot_vecs=jnp.asarray(pvecs), **kw)
    tcfg = TConfig(dims=D, metric=metric, storage_dtype=storage)
    tslots, tpv, tpn = pivot_rows(torch.from_numpy(slots), torch.from_numpy(pvecs))
    td, ti, tst = tsearch.hnsw_search(tg, tcfg, torch.from_numpy(q), pivot_slots=tslots,
                                      pivot_vecs=tpv, pivot_norms=tpn, **kw)
    assert tst == jst
    np.testing.assert_array_equal(np.sort(ti.numpy(), 1), np.sort(np.asarray(ji), 1))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=REL_TOL * _scale(q, tg.vectors.float().numpy(), metric))
    ud, ui, ust = tsearch.hnsw_search(tg, tcfg, torch.from_numpy(q), pivot_slots=tslots,
                                      pivot_vecs=torch.from_numpy(pvecs), **kw)
    assert ust == tst
    assert torch.equal(ui, ti) and torch.equal(ud.view(torch.int32), td.view(torch.int32))


def test_pivot_rows_hold_what_the_seeding_computes(built):
    """The cache's rows are the tape's rows in f32 and its norms the
    reduction `pivot_seeds` makes a batch, bit for bit; no pivots, no
    rows."""
    arrays, _, slots = built
    for storage in ("f32", "int8", "bf16"):
        tg = _tape_torch(_with_tape(arrays, np.zeros((1, D)), storage)[0], storage)
        s, pv, pn = pivot_rows(*graph_pivots(tg))
        assert torch.equal(s, torch.from_numpy(slots))
        assert pv.dtype == torch.float32
        assert torch.equal(pv, tg.vectors[s.clamp(min=0).long()].float())
        want = (tg.vectors[s.clamp(min=0).long()].float() ** 2).sum(-1)
        assert torch.equal(pn.view(torch.int32), want.view(torch.int32))
    assert pivot_rows(None, None) == (None, None, None)


def test_index_search_takes_the_cached_pivots(monkeypatch):
    """`HNSWIndex.search` passes its cached pivots (f32 rows and norms, one
    cache per graph version) to the seeding, and equals a search seeded
    from the tape's rows without norms, bit for bit."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2000, 16)).astype(np.float32)
    idx = HNSWIndex.build(x, TConfig(dims=16, m=6, storage_dtype="int8"), method="native",
                          device="cpu")
    q = torch.from_numpy(rng.normal(size=(20, 16)).astype(np.float32))
    seen = []
    real = tsearch.scored_pivot_seeds

    def spy(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(tsearch, "scored_pivot_seeds", spy)
    d, rows = idx.search(q, 5, ef=32)
    slots, pv, pn = idx.pivots()
    assert idx.pivots()[2] is pn  # cached
    assert len(seen) == 1 and seen[0][4] is pv and seen[0][7] is pn
    assert pv.dtype == torch.float32 and pn.shape == slots.shape
    monkeypatch.setattr(tsearch, "scored_pivot_seeds", real)
    s_int8, v_int8 = graph_pivots(idx.graph)
    qs = q / idx.vector_scale
    ud, us = tsearch.hnsw_search(idx.graph, idx.config, qs, 5, ef=32, assume_all_valid=True,
                                 pivot_slots=s_int8, pivot_vecs=v_int8,
                                 rerank_tape=idx.rerank_tape)
    cd, cs = tsearch.hnsw_search(idx.graph, idx.config, qs, 5, ef=32, assume_all_valid=True,
                                 pivot_slots=slots, pivot_vecs=pv, pivot_norms=pn,
                                 rerank_tape=idx.rerank_tape)
    assert torch.equal(us, cs) and torch.equal(ud.view(torch.int32), cd.view(torch.int32))


def test_insert_wave_with_cached_pivots_equals_without():
    """The sharded insert's wave seeded from the cache (`pivot_rows`: f32
    rows and norms) and from the tape's rows alone: the same graph."""
    from vss_tpu_torch.index.exact_build import build_graph_exact

    rng = np.random.default_rng(2)
    d = 8
    vecs = np.concatenate([rng.normal(0, 1, (300, d)), rng.normal(40, 1, (300, d))])
    cfg = TConfig(dims=d, m=4, ef_construction=8)
    g, used = build_graph_exact(vecs.astype(np.float32), cfg, seed=1, capacity=700,
                                device=torch.device("cpu"))
    new = rng.normal(20, 15, (16, d)).astype(np.float32)
    lv = np.zeros(16, np.int32)
    ur, _ = build_mod.plan_wave_rows(lv, used, cfg.max_levels)
    args = (cfg, new, np.arange(600, 616), lv, ur, np.arange(600, 616), np.ones(16, bool), 8,
            4, 8)
    plain = build_mod._insert_wave_core(g.clone(), *args, pivots=graph_pivots(g))
    cached = build_mod._insert_wave_core(g.clone(), *args, pivots=pivot_rows(*graph_pivots(g)))
    for f in ("adj0", "upper_adj", "vectors"):
        assert torch.equal(getattr(plain, f), getattr(cached, f)), f


def test_scored_pivot_seeds_dispatch(monkeypatch):
    """Off the CPU (a meta tensor stands in for a CUDA one), the seeding is
    the product and one kernel launch for k <= SELECT_K_MAX, with the given
    norms or their reduction; above it, `pivot_seeds` and K1. On the CPU it
    never launches."""
    calls = []

    def launch(dots, qn, pn, slots, table, q, metric, k, splits=None):
        calls.append(("kernel", tuple(dots.shape), k, pn))
        return (torch.empty((q.shape[0], k), dtype=torch.int32, device=q.device),
                torch.empty((q.shape[0], k), device=q.device))

    def route(graph, config, q, slots, vecs, n, q_norms):
        calls.append(("route", n))
        return torch.empty((q.shape[0], n), dtype=torch.int32, device=q.device), None

    monkeypatch.setattr(tsearch, "_pivot_seeds_launch", launch)
    monkeypatch.setattr(tsearch, "pivot_seeds", route)
    monkeypatch.setattr(tsearch, "gather_distances",
                        lambda table, ids, q, metric, qn: torch.empty(ids.shape, device=q.device))
    meta = torch.device("meta")
    g = types.SimpleNamespace(vectors=torch.empty((5000, 16), dtype=torch.int8, device=meta))
    cfg = TConfig(dims=16)
    q = torch.empty((3, 16), device=meta)
    slots = torch.empty((4096,), dtype=torch.int32, device=meta)
    pv = torch.empty((4096, 16), device=meta)
    pn = torch.empty((4096,), device=meta)
    s, d = tsearch.scored_pivot_seeds(g, cfg, q, slots, pv, 4, None, pn)
    assert calls[-1][:3] == ("kernel", (3, 4096), 4) and calls[-1][3] is pn
    assert s.shape == (3, 4)
    tsearch.scored_pivot_seeds(g, cfg, q, slots, pv, tsearch.SELECT_K_MAX, None)
    assert calls[-1][:3] == ("kernel", (3, 4096), tsearch.SELECT_K_MAX)
    tsearch.scored_pivot_seeds(g, cfg, q, slots, pv, 300, None)
    assert calls[-1] == ("route", 300)
    tsearch.scored_pivot_seeds(g, cfg, q, slots[:7], pv[:7], 300, None)  # k = P = 7
    assert calls[-1][:3] == ("kernel", (3, 7), 7)

    def refuse(*a, **k):
        raise AssertionError("the kernel launched for CPU tensors")

    monkeypatch.undo()
    monkeypatch.setattr(tsearch._SEEDS, "launch", refuse)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(64, 16)).astype(np.float32))
    s = torch.arange(8, dtype=torch.int32)
    graph = types.SimpleNamespace(vectors=x)
    out = tsearch.scored_pivot_seeds(graph, cfg, x[:3], s, x[:8], 4, None)
    assert out[0].shape == (3, 4) and bool((out[0][:, 0] == torch.arange(3)).all())
