"""vss_tpu_torch.index.exact_build (the bulk builder), ivf_candidates and
repair on the CPU, against vss_tpu and against the exact oracle.

Two kinds of test:
  * the contract tests of `tests/test_exact_build.py`, ported: recall
    against `bruteforce_topk`, determinism, the bf16 distance buffer,
    greedy-descent routing, the IVF pass, the connectivity repair, the
    scan pass and the candidate modes;
  * cross-package parity: the same numpy inputs through both packages.
    On integer-valued vectors every f32 dot product, norm and distance is
    exact in both, and both break ties by the lower position, so the
    candidate lists and the graphs must be equal array for array:
    `adj0`, `upper_adj`, `levels`, `upper_row` and `entry`, outside the
    scatter sinks (slot `capacity - 1`, row `upper_capacity - 1`, which
    the JAX package's pad rows write and nothing reads). The row counts
    are multiples of 256, so the JAX package pads no base-layer chunk.
    On real-valued data `exact_knn`'s ids must be equal and its distances
    within rtol 1e-5, atol 1e-3 (the two packages sum the products in
    other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vss_tpu.index.exact_build as jeb
import vss_tpu_torch.index.exact_build as teb
from vss_tpu.index.dense import HNSWIndex as JIndex
from vss_tpu.index.graph import HNSWConfig as JConfig
from vss_tpu.index.ivf_candidates import ivf_candidates as j_ivf
from vss_tpu_torch import HNSWIndex
from vss_tpu_torch.index.graph import HNSWConfig as TConfig
from vss_tpu_torch.index.ivf_candidates import _score_groups, ivf_candidates
from vss_tpu_torch.index.repair import reachable_mask, repair_connectivity
from vss_tpu_torch.index.search import hnsw_search
from vss_tpu_torch.ops import bruteforce_topk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one intra-op thread each."""
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


def _search_rows(graph, cfg, q, k, ef=64):
    _, si = hnsw_search(graph, cfg, torch.from_numpy(q), k, ef=ef)
    rows = graph.slot_to_rowid[si.clamp(min=0).long()]
    return torch.where(si >= 0, rows, -1).numpy()


def _truth(q, vecs, k, metric="l2sq"):
    return bruteforce_topk(torch.from_numpy(q), torch.from_numpy(vecs), k, metric,
                           device="cpu")[1].numpy()


def _int_vectors(rng, n, d):
    return rng.integers(-8, 9, (n, d)).astype(np.float32)


# ---------------------------------------------------------------- contract


@pytest.mark.parametrize("metric", ["l2sq", "cosine"])
def test_exact_build_recall(rng, metric):
    n, d, k = 4000, 32, 10
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    cfg = TConfig(dims=d, metric=metric)
    graph, _ = teb.build_graph_exact(vecs, cfg, device="cpu")
    assert int(graph.count) == n
    q = rng.standard_normal((64, d)).astype(np.float32)
    r = recall(_search_rows(graph, cfg, q, k), _truth(q, vecs, k, metric))
    assert r >= 0.92, f"{metric} recall {r}"


def test_exact_build_deterministic(rng):
    vecs = rng.standard_normal((1200, 16)).astype(np.float32)
    cfg = TConfig(dims=16, metric="l2sq")
    g1, u1 = teb.build_graph_exact(vecs, cfg, seed=7, device="cpu")
    g2, u2 = teb.build_graph_exact(vecs, cfg, seed=7, device="cpu")
    assert u1 == u2
    assert torch.equal(g1.adj0, g2.adj0) and torch.equal(g1.levels, g2.levels)


def test_exact_knn_matches_oracle(rng):
    n, d, C = 700, 24, 8
    vecs = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    ids = torch.arange(n, dtype=torch.int32)
    _, ki = teb.exact_knn(vecs, ids, C, "l2sq")
    # oracle: top C+1 holds self at rank 0 (distance 0)
    _, oi = bruteforce_topk(vecs, vecs, C + 1, "l2sq", device="cpu")
    ki, oi = ki.numpy(), oi.numpy()
    for r in range(0, n, 97):
        assert ki[r].tolist() == [i for i in oi[r].tolist() if i != r][:C]


def test_exact_knn_bf16_distances(rng):
    """The card's default (a bf16 distance buffer) keeps near-oracle
    candidate quality; exercised explicitly since the CPU defaults to f32."""
    n, d, C = 1500, 32, 16
    vecs = torch.from_numpy((rng.standard_normal((n, d)) * 20).astype(np.float32))
    ids = torch.arange(n, dtype=torch.int32)
    _, ki16 = teb.exact_knn(vecs, ids, C, "l2sq", dist_bf16=True)
    _, ki32 = teb.exact_knn(vecs, ids, C, "l2sq", dist_bf16=False)
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / C
                       for a, b in zip(ki16.numpy(), ki32.numpy())])
    assert overlap >= 0.95, overlap


def test_exact_build_greedy_descent_routing(rng):
    """Upper levels route a plain greedy descent (no pivot seeding) to good
    seeds."""
    n, d, k = 4000, 24, 10
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    cfg = TConfig(dims=d, metric="l2sq")
    graph, _ = teb.build_graph_exact(vecs, cfg, device="cpu")
    q = rng.standard_normal((32, d)).astype(np.float32)
    assert recall(_search_rows(graph, cfg, q, k), _truth(q, vecs, k)) >= 0.9


def test_ivf_candidates_quality(rng):
    """The locality-blocked pass gives near-exact top-C lists on clustered
    data: high overlap with the exact pass, deterministic given the seed,
    no self, no duplicates."""
    n, d, C = 6000, 24, 16
    centers = rng.standard_normal((30, d)).astype(np.float32) * 8
    vecs = centers[rng.integers(0, 30, n)] + rng.standard_normal((n, d)).astype(np.float32)
    ids = torch.arange(n, dtype=torch.int32)
    xv = torch.from_numpy(vecs)
    _, ei = teb.exact_knn(xv, ids, C, "l2sq")
    _, ii = ivf_candidates(xv, ids, C, "l2sq", window=128, probes=8, seed=3)
    ei, ii = ei.numpy(), ii.numpy()
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / C for a, b in zip(ei, ii)])
    assert overlap >= 0.85, overlap
    _, di = ivf_candidates(xv, ids, C, "l2sq", window=128, probes=8, seed=3)
    assert (di.numpy() == ii).all()
    for r in range(0, n, 613):
        row = ii[r][ii[r] >= 0]
        assert r not in row.tolist()
        assert len(set(row.tolist())) == row.size


def test_ivf_build_recall(rng):
    """A graph built from IVF candidates holds the exact build's bar."""
    n, d, k = 4000, 32, 10
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    cfg = TConfig(dims=d, metric="l2sq")
    graph, _ = teb.build_graph_exact(vecs, cfg, candidate_mode="ivf", device="cpu")
    assert int(graph.count) == n
    q = rng.standard_normal((64, d)).astype(np.float32)
    r = recall(_search_rows(graph, cfg, q, k), _truth(q, vecs, k))
    assert r >= 0.9, f"ivf-build recall {r}"


def test_repair_bridges_disconnected_clusters(rng):
    """Two well-separated clusters: kNN edges cannot connect them; the
    repair makes every occupied slot reachable and search finds
    far-cluster neighbours."""
    a = rng.normal(0, 1, (900, 16)).astype(np.float32)
    b = rng.normal(80, 1, (900, 16)).astype(np.float32)
    vecs = np.concatenate([a, b])
    idx = HNSWIndex.build(vecs, TConfig(dims=16, metric="l2sq"), method="exact", device="cpu")
    assert idx.build_stats["bridged"] > 0
    assert int(reachable_mask(idx.graph).sum()) == 1800
    q = rng.normal(80, 1, (8, 16)).astype(np.float32)
    _, rows = idx.search(q, k=10)
    assert recall(rows.numpy(), _truth(q, vecs, 10)) >= 0.9


def test_repair_noop_on_connected_graph(rng):
    vecs = rng.standard_normal((1000, 16)).astype(np.float32)
    cfg = TConfig(dims=16, metric="l2sq")
    graph, _ = teb.build_graph_exact(vecs, cfg, device="cpu")
    g2, n_bridged = repair_connectivity(graph, cfg)
    assert n_bridged == 0
    assert torch.equal(graph.adj0, g2.adj0)


def test_ivf_score_groups_bf16_arm(rng):
    """The bf16 scoring arm (taken on the card) keeps the f32 output
    contract and near-exact top-C overlap with the f32 arm."""
    W, window, d, probes, C = 16, 64, 16, 4, 8
    tape = rng.standard_normal((W, window, d)).astype(np.float32)
    gids = torch.arange(W * window, dtype=torch.int32).reshape(W, window)
    cents = tape.mean(axis=1)
    dm = ((cents[:, None] - cents[None, :]) ** 2).sum(-1)
    nbr = torch.from_numpy(np.argsort(dm, axis=1)[:, :probes].astype(np.int32))
    args = (gids, nbr, C, "l2sq", 8, window, probes)
    d32, i32_ = _score_groups(torch.from_numpy(tape), *args, score_bf16=False)
    d16, i16_ = _score_groups(torch.from_numpy(tape).to(torch.bfloat16), *args,
                              score_bf16=True)
    assert d16.dtype == torch.float32
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / C
                       for a, b in zip(i32_.numpy(), i16_.numpy())])
    assert overlap >= 0.9, overlap


def test_scan_candidates_matches_exact_knn():
    """The scan candidate pass reproduces exact_knn's lists: same ids
    (self dropped), ascending distances. On the CPU `scan_topk` runs K2's
    plain version, the winnow and the f32 rerank at keep = C + 16."""
    rng = np.random.default_rng(3)
    n, d, C = 3000, 24, 16
    xv = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    ids = torch.arange(n, dtype=torch.int32)
    _, ei = teb.exact_knn(xv, ids, C, "l2sq", fast_matmul=False)
    sd, si = teb.scan_candidates(xv, xv, torch.ones(n, dtype=torch.bool), (xv * xv).sum(1),
                                 C + 1, "l2sq", batch=1024)
    ei, sd, si = ei.numpy(), sd.numpy(), si.numpy()
    for r in range(0, n, 197):
        np.testing.assert_array_equal(si[r][si[r] >= 0][:C], ei[r][:C])
    f = np.where(si >= 0, sd, np.inf)
    assert (np.diff(f[:, :C + 1][np.isfinite(f[:, :C + 1]).all(1)], axis=1) >= 0).all()


def test_build_graph_exact_scan_mode_cpu_fallback():
    """candidate_mode='scan' end to end on the CPU: search recall matches
    the exact mode's bar."""
    rng = np.random.default_rng(4)
    n, d, k = 4000, 24, 10
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((48, d)).astype(np.float32)
    cfg = TConfig(dims=d)
    stats = {}
    graph, _ = teb.build_graph_exact(vecs, cfg, candidate_mode="scan", device="cpu",
                                     stats=stats)
    assert stats["mode"] == "scan"
    assert recall(_search_rows(graph, cfg, q, k, ef=96), _truth(q, vecs, k)) >= 0.9


@pytest.mark.parametrize("clustered", [False, True])
def test_auto_past_the_threshold_takes_ivf_on_the_cpu(monkeypatch, clustered):
    """Past _IVF_AUTO_MIN_N (lowered here) 'auto' takes 'ivf' with
    NN-descent on CPU tensors ('hybrid' is the card's); an explicit
    'hybrid' takes the scan pass exactly where the sampled list recall
    falls below the bar."""
    rng = np.random.default_rng(6)
    n, d, k = 6144, 16, 10
    if clustered:
        centers = rng.standard_normal((24, d)).astype(np.float32) * 10
        vecs = centers[rng.integers(0, 24, n)] + rng.standard_normal((n, d)).astype(np.float32)
    else:
        vecs = rng.standard_normal((n, d)).astype(np.float32)
    q = vecs[:32] + 0.01
    cfg = TConfig(dims=d)
    monkeypatch.setattr(teb, "_IVF_AUTO_MIN_N", 4096)
    idx = HNSWIndex.build(vecs, cfg, method="exact", device="cpu")
    assert idx.build_stats["mode"] == "ivf"
    _, rows = idx.search(q, k, ef=64)
    assert recall(rows.numpy(), _truth(q, vecs, k)) >= 0.9
    for bar in (0.60, 1.01):  # the default bar, and one no list can pass
        stats = {}
        graph, _ = teb.build_graph_exact(vecs, cfg, candidate_mode="hybrid", device="cpu",
                                         recall_bar=bar, stats=stats)
        assert stats["mode"] == "hybrid"
        assert stats["scan_fallback"] == (stats["ivf_sampled_recall"] < bar)
        assert recall(_search_rows(graph, cfg, q, k), _truth(q, vecs, k)) >= 0.9
    assert stats["scan_fallback"]


# ---------------------------------------------------------------- parity


@pytest.mark.parametrize("integer", [True, False])
def test_exact_knn_equals_jax(integer):
    rng = np.random.default_rng(11)
    n, d, C = 1500, 20, 12
    vecs = (_int_vectors(rng, n, d) if integer
            else (rng.standard_normal((n, d)) * 20).astype(np.float32))
    ids = np.arange(n, dtype=np.int32)
    # a tile narrower than n runs the merge with the running best
    jd, ji = jeb.exact_knn(jnp.asarray(vecs), jnp.asarray(ids), C, "l2sq", tile=512, block=256)
    td, ti = teb.exact_knn(torch.from_numpy(vecs), torch.from_numpy(ids), C, "l2sq", tile=512,
                           block=256)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-3)
    if integer:
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_ivf_candidates_and_nn_descent_equal_jax():
    """The same seed gives the same IVF lists, and the same NN-descent
    rounds over them, in both packages."""
    from vss_tpu.index.nn_descent import nn_descent_refine as j_nnd
    from vss_tpu_torch.index.nn_descent import nn_descent_refine as t_nnd

    rng = np.random.default_rng(12)
    n, d, C = 6144, 16, 24
    vecs = _int_vectors(rng, n, d)
    ids = np.arange(n, dtype=np.int32)
    jd, ji = j_ivf(jnp.asarray(vecs), jnp.asarray(ids), C, "l2sq", seed=5)
    td, ti = ivf_candidates(torch.from_numpy(vecs), torch.from_numpy(ids), C, "l2sq", seed=5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jd2, ji2 = j_nnd(jnp.asarray(vecs), jd, ji, "l2sq", max_rounds=2, seed=3)
    td2, ti2 = t_nnd(torch.from_numpy(vecs), td, ti, "l2sq", max_rounds=2, seed=3)
    assert not torch.equal(ti2, ti)  # rounds ran
    np.testing.assert_array_equal(ti2.numpy(), np.asarray(ji2))
    np.testing.assert_array_equal(td2.numpy(), np.asarray(jd2))


def _graphs_equal(jg, tg):
    cap, ucap = tg.capacity, tg.upper_capacity
    assert (int(jg.entry), int(jg.max_level), int(jg.count)) == (
        int(tg.entry), int(tg.max_level), int(tg.count))
    for f, rows in (("adj0", cap - 1), ("upper_adj", ucap - 1), ("levels", cap),
                    ("upper_row", cap), ("slot_to_rowid", cap), ("valid", cap)):
        np.testing.assert_array_equal(getattr(tg, f).numpy()[:rows],
                                      np.asarray(getattr(jg, f))[:rows], err_msg=f)


@pytest.mark.parametrize("mode", ["exact", "ivf"])
def test_build_graph_exact_equals_jax(mode):
    rng = np.random.default_rng(13)
    n, d = 6144 if mode == "ivf" else 2048, 16
    vecs = _int_vectors(rng, n, d)
    kw = dict(dims=d, m=8)
    jg, ju = jeb.build_graph_exact(vecs, JConfig(**kw), seed=2, candidate_mode=mode)
    stats = {}
    tg, tu = teb.build_graph_exact(vecs, TConfig(**kw), seed=2, candidate_mode=mode,
                                   device="cpu", stats=stats)
    assert ju == tu and stats["mode"] == mode
    _graphs_equal(jg, tg)


def test_index_build_exact_int8_equals_jax():
    """`HNSWIndex.build(method="exact")` on an int8 tape: the scale, the
    tape, the side tape (unscaled vectors divided on the device) and the
    graph equal the JAX package's. The largest |value| is 254, so the
    scale is exactly 2 and dividing by it is exact in both packages (the
    JAX package's compiled divide may multiply by the reciprocal, one ulp
    off an exact quotient)."""
    rng = np.random.default_rng(14)
    n, d = 1280, 16
    vecs = rng.integers(-254, 255, (n, d)).astype(np.float32)
    vecs[0, 0] = 254.0
    kw = dict(dims=d, m=8, storage_dtype="int8")
    j = JIndex.build(vecs, JConfig(**kw), method="exact")
    t = HNSWIndex.build(vecs, TConfig(**kw), method="exact", device="cpu")
    assert t.vector_scale == j.vector_scale and t.next_slot == j.next_slot == n
    assert t.rowid_to_slot == j.rowid_to_slot and t._insert_seed == j._insert_seed
    assert t.dirty and t.upper_used == j.upper_used
    np.testing.assert_array_equal(t.rerank_tape.numpy(), np.asarray(j.rerank_tape))
    np.testing.assert_array_equal(t.graph.vectors.numpy(), np.asarray(j.graph.vectors))
    _graphs_equal(j.graph, t.graph)
