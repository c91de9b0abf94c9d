"""vss_tpu_torch.index.build against vss_tpu.index.build on the CPU.

The same wave goes through `insert_wave` of both packages: once into an
empty graph and once into a host-built graph carried across with
`convert`. The vectors are small integers, so every f32 dot product,
norm and distance is exact in both packages whatever the order of the
sums, and the two builders must then make the same decisions: with f32
storage every graph array is compared for equality outside the scatter
sinks (slot `capacity - 1`, row `upper_capacity - 1`), which several
rows may write at once and nothing reads. With int8 and bf16 storage the
tapes must be equal and the recall of a search over both graphs within
0.02. `build_graph_batched` is held to the recall, determinism and edge
cases of `tests/test_build.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vss_tpu.index.build as jbuild
import vss_tpu.index.search as jsearch
import vss_tpu_torch.index.build as tbuild
import vss_tpu_torch.index.search as tsearch
from vss_tpu.index.graph import HNSWConfig as JConfig
from vss_tpu.index.graph import HNSWGraph as JGraph
from vss_tpu.index.graph import empty_graph as jax_empty_graph
from vss_tpu.index.graph import sample_levels as jax_sample_levels
from vss_tpu.index.host_build import build_host_graph as jax_build_host_graph
from vss_tpu.index.host_build import host_graph_to_device as jax_host_graph_to_device
from vss_tpu_torch.convert import GRAPH_FIELDS, graph_from_arrays
from vss_tpu_torch.index.graph import HNSWConfig as TConfig
from vss_tpu_torch.index.graph import empty_graph, sample_levels
from vss_tpu_torch.ops import bruteforce_topk

D, W, EFC, M = 16, 64, 32, 8
CAP = 264  # 200 host-built rows + one wave, inside one capacity


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


def _cfgs(metric="l2sq", storage="f32"):
    kw = dict(dims=D, metric=metric, m=M, ef_construction=EFC, storage_dtype=storage)
    return JConfig(**kw), TConfig(**kw)


def _int_vectors(rng, n):
    """Integer-valued vectors: sums of products stay far below 2^24, so
    f32 arithmetic on them is exact."""
    return rng.integers(-8, 9, (n, D)).astype(np.float32)


def _arrays(graph) -> dict:
    """The graph's fields as numpy arrays (either package's graph); a
    bf16 tape as its int16 bit pattern."""
    out = {}
    for f in GRAPH_FIELDS:
        a = getattr(graph, f)
        if isinstance(a, torch.Tensor):
            a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
        else:
            a = np.asarray(a)
            a = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        out[f] = a
    return out


def _wave(rng, first_slot, first_row, n_valid=W - 5, seed=3):
    """A wave of W rows, the last W - n_valid of them padding."""
    jcfg, _ = _cfgs()
    vecs = _int_vectors(rng, W)
    levels = np.zeros(W, np.int32)
    levels[:n_valid] = jax_sample_levels(n_valid, jcfg, seed)
    urows, next_row = jbuild.plan_wave_rows(levels, first_row, jcfg.max_levels)
    slots = np.arange(first_slot, first_slot + W, dtype=np.int32)
    rowids = np.where(np.arange(W) < n_valid, 1000 + np.arange(W), -1).astype(np.int32)
    valid = np.arange(W) < n_valid
    return vecs, slots, levels, urows, rowids, valid


def _insert_both(arrays, wave, metric="l2sq", storage="f32"):
    jcfg, tcfg = _cfgs(metric, storage)
    jg = JGraph(**{f: jnp.asarray(a) for f, a in arrays.items()})
    tg = graph_from_arrays(arrays, "cpu")
    before = {f: getattr(tg, f).clone() for f in GRAPH_FIELDS}
    jout = jbuild.insert_wave(jg, jcfg, *(jnp.asarray(a) for a in wave), EFC, 4, M)
    tout = tbuild.insert_wave(tg, tcfg, *wave, EFC, 4, M)
    # the port's insert_wave is pure, like the JAX function
    for f in GRAPH_FIELDS:
        assert torch.equal(getattr(tg, f), before[f]), f
    return jout, tout


def _assert_graphs_equal(jg, tg):
    ja, ta = _arrays(jg), _arrays(tg)
    cap, ucap = ja["adj0"].shape[0], ja["upper_adj"].shape[0]
    for f in GRAPH_FIELDS:
        j, t = ja[f], ta[f]
        if f == "upper_adj":
            j, t = j[: ucap - 1], t[: ucap - 1]
        elif j.ndim >= 1:
            j, t = j[: cap - 1], t[: cap - 1]
        if f in ("adj0", "upper_adj") and not np.array_equal(j, t):
            bad = np.flatnonzero((j != t).any(1))[:3]
            msg = f"{f} rows {bad} differ: vss_tpu {j[bad].tolist()} port {t[bad].tolist()}"
            if f == "adj0" and ja["vectors"].dtype == np.float32:
                # a difference that is no f32 near-tie (relative gap over
                # 1e-6 between the candidates' distances) is a fault
                x = ja["vectors"]
                dist = lambda r, ids: ((x[np.maximum(ids, 0)] - x[r]) ** 2).sum(-1).tolist()
                msg += "".join(
                    f"\nrow {r}: l2sq to vss_tpu's {dist(r, j[r])}, to the port's {dist(r, t[r])}"
                    for r in bad)
            raise AssertionError(msg)
        np.testing.assert_array_equal(t, j, err_msg=f)


@pytest.fixture(scope="module")
def host_arrays():
    rng = np.random.default_rng(0)
    jcfg, _ = _cfgs()
    vecs = _int_vectors(rng, 200)
    g = jax_host_graph_to_device(jax_build_host_graph(vecs, jcfg, seed=0), capacity=CAP)
    arrays = _arrays(g)
    # room for the wave's upper rows and the sink row
    ucap = arrays["upper_adj"].shape[0] + 64
    arrays["upper_adj"] = np.concatenate(
        [arrays["upper_adj"], np.full((64, M), -1, np.int32)])
    used = int(arrays["levels"].sum())
    assert used + 64 <= ucap
    return arrays, used


def test_plan_wave_rows_equal():
    rng = np.random.default_rng(1)
    for n in (1, 7, 64):
        lv = rng.integers(0, 4, n).astype(np.int32)
        jr, jn = jbuild.plan_wave_rows(lv, 11, 6)
        tr, tn = tbuild.plan_wave_rows(lv, 11, 6)
        np.testing.assert_array_equal(tr, jr)
        assert tn == jn


def test_dedupe_keep_first_equal():
    rng = np.random.default_rng(2)
    ids = rng.integers(-1, 12, (40, 24)).astype(np.int32)
    want = np.asarray(jsearch._dedupe_keep_first(jnp.asarray(ids)))
    got = tsearch._dedupe_keep_first(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    for row_in, row in zip(ids, got):
        kept = row[row >= 0]
        assert len(set(kept.tolist())) == kept.size
        assert set(kept.tolist()) == set(row_in[row_in >= 0].tolist())


def test_insert_wave_into_empty_graph_equals_jax():
    rng = np.random.default_rng(3)
    jcfg, _ = _cfgs()
    arrays = _arrays(jax_empty_graph(jcfg, CAP, 128))
    jg, tg = _insert_both(arrays, _wave(rng, 0, 0))
    _assert_graphs_equal(jg, tg)
    assert int(tg.count) == W - 5 and int(tg.entry) >= 0


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_insert_wave_into_host_graph_equals_jax(host_arrays, metric):
    arrays, used = host_arrays
    rng = np.random.default_rng(4)
    jg, tg = _insert_both(arrays, _wave(rng, 200, used), metric=metric)
    _assert_graphs_equal(jg, tg)
    assert int(tg.count) == 200 + W - 5
    # the wave's back-links reached the old nodes
    assert bool((tg.adj0[:200] >= 200).any())


@pytest.mark.parametrize("storage", ["int8", "bf16"])
def test_insert_wave_quantized_tapes(host_arrays, storage):
    arrays, used = host_arrays
    jcfg, tcfg = _cfgs(storage=storage)
    arrays = dict(arrays)
    arrays["vectors"] = np.array(jbuild.cast_to_tape(jnp.asarray(arrays["vectors"]), jcfg))
    rng = np.random.default_rng(5)
    wave = _wave(rng, 200, used)
    jg, tg = _insert_both(arrays, wave, storage=storage)
    np.testing.assert_array_equal(
        _arrays(tg)["vectors"][: CAP - 1], _arrays(jg)["vectors"][: CAP - 1])
    q = _int_vectors(rng, 32) + 0.25
    _, truth = bruteforce_topk(torch.from_numpy(q), tg.vectors.float(), 5, "l2sq",
                               valid_mask=tg.valid, device="cpu")
    _, ji = jsearch.hnsw_search(jg, jcfg, jnp.asarray(q), 5, ef=32)
    _, ti = tsearch.hnsw_search(tg, tcfg, torch.from_numpy(q), 5, ef=32)
    rj, rt = _recall(np.asarray(ji), truth.numpy()), _recall(ti.numpy(), truth.numpy())
    assert rt >= 0.9 and abs(rj - rt) <= 0.02, (rj, rt)


def _recall(ids, true_ids):
    hits = sum(
        len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist()))
        for a, b in zip(ids, true_ids)
    )
    return hits / true_ids[true_ids >= 0].size


def _search_rows(graph, cfg, q, k, ef=64):
    sd, si = tsearch.hnsw_search(graph, cfg, torch.from_numpy(q), k=k, ef=ef)
    rows = torch.where(si >= 0, graph.slot_to_rowid[si.clamp(min=0).long()], -1)
    return sd.numpy(), si.numpy(), rows.numpy()


@pytest.mark.parametrize("metric", ["l2sq", "cosine"])
def test_batched_build_recall(metric):
    rng = np.random.default_rng(0)
    n, d, k = 1500, 32, 10
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    cfg = TConfig(dims=d, metric=metric, ef_construction=48)
    graph, _ = tbuild.build_graph_batched(vecs, cfg, wave_size=512, device="cpu")
    assert int(graph.count) == n
    q = rng.standard_normal((100, d)).astype(np.float32)
    _, _, rows = _search_rows(graph, cfg, q, k)
    _, bi = bruteforce_topk(torch.from_numpy(q), torch.from_numpy(vecs), k, metric, device="cpu")
    r = _recall(rows, bi.numpy())
    assert r >= 0.90, f"{metric} recall {r}"


def test_build_deterministic():
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((600, 16)).astype(np.float32)
    cfg = TConfig(dims=16, ef_construction=48)
    g1, u1 = tbuild.build_graph_batched(vecs, cfg, wave_size=128, seed=7, device="cpu")
    g2, u2 = tbuild.build_graph_batched(vecs, cfg, wave_size=128, seed=7, device="cpu")
    assert u1 == u2
    assert torch.equal(g1.adj0, g2.adj0)
    assert torch.equal(g1.upper_adj, g2.upper_adj)
    assert int(g1.entry) == int(g2.entry)


def test_build_tiny():
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((5, 8)).astype(np.float32)
    cfg = TConfig(dims=8)
    graph, _ = tbuild.build_graph_batched(vecs, cfg, wave_size=1024, device="cpu")
    sd, si, _ = _search_rows(graph, cfg, vecs[:3], 1)
    assert si[:, 0].tolist() == [0, 1, 2]
    np.testing.assert_allclose(sd[:, 0], 0.0, atol=1e-6)


def test_build_single_row():
    vecs = np.ones((1, 4), np.float32)
    cfg = TConfig(dims=4)
    graph, _ = tbuild.build_graph_batched(vecs, cfg, device="cpu")
    _, si, _ = _search_rows(graph, cfg, np.ones((1, 4), np.float32), 3)
    assert si[0].tolist() == [0, -1, -1]


def test_wave_sizes_equivalent_quality():
    """Different wave sizes need not give identical graphs, but recall
    must hold across them."""
    rng = np.random.default_rng(0)
    n, d, k = 1200, 24, 10
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    cfg = TConfig(dims=d, ef_construction=48)
    q = rng.standard_normal((50, d)).astype(np.float32)
    _, bi = bruteforce_topk(torch.from_numpy(q), torch.from_numpy(vecs), k, "l2sq", device="cpu")
    for wave in (128, 2048):
        graph, _ = tbuild.build_graph_batched(vecs, cfg, wave_size=wave, device="cpu")
        _, si, _ = _search_rows(graph, cfg, q, k)
        r = _recall(si, bi.numpy())
        assert r >= 0.90, f"wave={wave} recall {r}"


def test_build_graph_batched_equals_jax():
    """Three waves of the whole builder, integer data: equal graphs."""
    rng = np.random.default_rng(6)
    vecs = _int_vectors(rng, 3 * W - 7)
    jcfg, tcfg = _cfgs()
    jg, ju = jbuild.build_graph_batched(vecs, jcfg, wave_size=W, seed=1, fused=False)
    tg, tu = tbuild.build_graph_batched(vecs, tcfg, wave_size=W, seed=1, device="cpu")
    assert tu == ju
    _assert_graphs_equal(jg, tg)


def test_build_graph_batched_needs_a_gpu_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbuild.build_graph_batched(np.zeros((4, 8), np.float32), TConfig(dims=8))
    assert sample_levels(5, TConfig(dims=8), 0).shape == (5,)
    assert empty_graph(TConfig(dims=8), 64, device="cpu").capacity == 64
