"""`beam_search_base` of the port: the properties the `beam_search` kernel
(`csrc/beam.cu`, one thread block per query) rests on, checked where they
can run without a card.

(a) Per-query independence: the batch's lockstep loop equals the same call
    one query at a time, the iteration counter being the largest of the
    single runs and the evaluation counter their sum.
(b) The port's `beam_search_base` against `vss_tpu`'s on the same graph
    (the JAX side on its XLA path, `fused=False`): ids equal, distances
    within 1e-5 relative.
(c) A scalar model of the kernel's merge, the compare-exchange pairs in the
    order `beam.cu` runs them, against `_merge_sorted`.
(d) The wrapper: CPU tensors take the plain loop; pools over the
    shared-memory limit launch in the wide layout, and only a query too
    wide for shared memory raises before any launch.

Inputs come from a numpy seed. The graph's vectors are integer-valued in
(a) and (b), so every f32 sum is exact in both packages and no near-tie can
order differently.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vss_tpu.index.search as jsearch
import vss_tpu_torch.index.search as tsearch
from vss_tpu.index.graph import HNSWConfig as JConfig
from vss_tpu.index.graph import HNSWGraph as JGraph
from vss_tpu.index.host_build import build_host_graph, host_graph_to_device
from vss_tpu_torch import csrc
from vss_tpu_torch.convert import GRAPH_FIELDS, graph_from_arrays
from vss_tpu_torch.index.graph import HNSWConfig as TConfig
from vss_tpu_torch.ops.gather import gather_distances

N, D, M, B = 1200, 24, 8, 10
GRID = [(dual, hist, E, level)
        for dual in (False, True) for hist in (True, False)
        for E in (1, 2, 4) for level in (0, 1)]


def _grid_id(case):
    dual, hist, E, level = case
    return f"{'dual' if dual else 'single'}-{'hist' if hist else 'nohist'}-E{E}-level{level}"


@pytest.fixture(scope="module")
def world():
    """One host-built graph over integer-valued vectors, queries, an
    `allow` mask with a fifth of the nodes barred, and seeds for both
    levels: [B, 3] at level 0 (one row empty, one partly), [B] at level 1."""
    rng = np.random.default_rng(7)
    vecs = rng.integers(-7, 8, (N, D)).astype(np.float32)
    jcfg = JConfig(dims=D, m=M)
    built = host_graph_to_device(build_host_graph(vecs, jcfg, seed=0))
    arrays = {f: np.asarray(getattr(built, f)) for f in GRAPH_FIELDS}
    q = rng.integers(-7, 8, (B, D)).astype(np.float32)
    allow = arrays["valid"] & (rng.random(arrays["valid"].shape[0]) > 0.2)
    seeds0 = rng.integers(0, N, (B, 3)).astype(np.int32)
    seeds0[2] = -1
    seeds0[5, 1:] = -1
    upper = np.nonzero(arrays["levels"] >= 1)[0]
    seeds1 = upper[rng.integers(0, upper.size, B)].astype(np.int32)
    return arrays, q, allow, seeds0, seeds1


def _torch_inputs(world, level):
    arrays, q, allow, seeds0, seeds1 = world
    g = graph_from_arrays(arrays, "cpu")
    cfg = TConfig(dims=D, m=M)
    qt = torch.from_numpy(q)
    seeds = torch.from_numpy(seeds0 if level == 0 else seeds1)
    sd = gather_distances(g.vectors, seeds if seeds.dim() == 2 else seeds[:, None], qt, "l2sq")
    return g, cfg, qt, seeds, sd.reshape(seeds.shape), torch.from_numpy(allow)


@pytest.mark.parametrize("case", GRID, ids=_grid_id)
def test_batch_equals_one_query_at_a_time(world, case):
    dual, hist, E, level = case
    g, cfg, q, seeds, seed_d, allow = _torch_inputs(world, level)
    kw = dict(expand=E, level=level, dual_pool=dual, use_history=hist)
    res_d, res_i, cand_i, (iters, evals) = tsearch.beam_search_base(
        g, cfg, q, seeds, seed_d, 16, allow, **kw)
    single_iters, single_evals = [], []
    for b in range(B):
        d1, i1, c1, (it1, ev1) = tsearch.beam_search_base(
            g, cfg, q[b:b + 1], seeds[b:b + 1], seed_d[b:b + 1], 16, allow, **kw)
        np.testing.assert_array_equal(d1[0].numpy(), res_d[b].numpy())
        np.testing.assert_array_equal(i1[0].numpy(), res_i[b].numpy())
        np.testing.assert_array_equal(c1[0].numpy(), cand_i[b].numpy())
        single_iters.append(int(it1))
        single_evals.append(int(ev1))
    assert int(iters) == max(single_iters)
    assert int(evals) == sum(single_evals)
    assert min(single_iters) < max(single_iters)  # the queries do end at different times


@pytest.mark.parametrize("case", GRID, ids=_grid_id)
def test_beam_search_base_matches_jax(world, case):
    dual, hist, E, level = case
    arrays, qn, allow_n, seeds0, seeds1 = world
    g, cfg, q, seeds, seed_d, allow = _torch_inputs(world, level)
    kw = dict(expand=E, level=level, dual_pool=dual, use_history=hist)
    td, ti, tc, (t_it, t_ev) = tsearch.beam_search_base(g, cfg, q, seeds, seed_d, 16, allow, **kw)
    jg = JGraph(**{f: jnp.asarray(a) for f, a in arrays.items()})
    jd, ji, jc, (j_it, j_ev) = jsearch.beam_search_base(
        jg, JConfig(dims=D, m=M), jnp.asarray(qn), jnp.asarray(seeds.numpy()),
        jnp.asarray(seed_d.numpy()), 16, jnp.asarray(allow_n), fused=False, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    jd = np.asarray(jd)
    np.testing.assert_array_equal(np.isfinite(td.numpy()), np.isfinite(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td.numpy()[fin], jd[fin], rtol=1e-5)
    assert (int(t_it), int(t_ev)) == (int(j_it), int(j_ev))


def _kernel_merge(a, b, num_out):
    """The merge of `csrc/beam.cu` on one row, in scalar Python: the pool
    `a` (key, id, flag) in the first slots of a power-of-two buffer, the
    padding (+inf, -1, flag set) after it, the sorted batch `b` reversed
    into the tail (rank r at slot P - 1 - r), then the compare-exchange
    pairs p = 0 .. P/2 - 1 of every step = P/2 .. 1 with
    lo = (p / step) * 2 * step + p % step, hi = lo + step, swapping the
    whole entry when key[lo] > key[hi]."""
    ef, n = len(a), len(b)
    P = 1
    while P < ef + n:
        P <<= 1
    buf = list(a) + [(float("inf"), -1, 1)] * (P - ef - n) + [None] * n
    for rank, entry in enumerate(b):
        buf[P - 1 - rank] = entry
    step = P >> 1
    while step >= 1:
        for p in range(P >> 1):
            lo = (p // step) * 2 * step + p % step
            hi = lo + step
            if buf[lo][0] > buf[hi][0]:
                buf[lo], buf[hi] = buf[hi], buf[lo]
        step >>= 1
    return buf[:num_out]


@pytest.mark.parametrize("na,nb", [(12, 7), (8, 8), (16, 32), (5, 3), (64, 32), (9, 1)])
@pytest.mark.parametrize("special", ["plain", "ties", "nan", "inf_tail"])
def test_kernel_merge_model_matches_merge_sorted(na, nb, special):
    rng = np.random.default_rng(na * 100 + nb)
    if special == "ties":
        a = np.sort(rng.integers(0, 4, na)).astype(np.float32)
        b = np.sort(rng.integers(0, 4, nb)).astype(np.float32)
    else:
        a = np.sort(rng.random(na)).astype(np.float32)
        b = np.sort(rng.random(nb)).astype(np.float32)
    if special == "nan":  # torch.sort puts NaN last
        a[-1] = np.nan
        b[-1] = np.nan
    if special == "inf_tail":  # a pool that is not full, a batch with sentinels
        a[na // 2:] = np.inf
        b[nb // 2:] = np.inf
    ai = rng.integers(0, 999, na).astype(np.int32)
    bi = rng.integers(0, 999, nb).astype(np.int32)
    af = rng.integers(0, 2, na).astype(np.int32)
    want = tsearch._merge_sorted(
        (torch.from_numpy(a)[None], torch.from_numpy(ai)[None], torch.from_numpy(af)[None]),
        (torch.from_numpy(b)[None], torch.from_numpy(bi)[None],
         torch.zeros((1, nb), dtype=torch.int32)), na)
    got = _kernel_merge(list(zip(a.tolist(), ai.tolist(), af.tolist())),
                        list(zip(b.tolist(), bi.tolist(), [0] * nb)), na)
    np.testing.assert_array_equal(np.array([g[0] for g in got], np.float32), want[0][0].numpy())
    np.testing.assert_array_equal(np.array([g[1] for g in got], np.int32), want[1][0].numpy())
    np.testing.assert_array_equal(np.array([g[2] for g in got], np.int32) != 0,
                                  want[2][0].numpy() != 0)


def test_cpu_tensors_take_the_plain_loop(world, monkeypatch):
    g, cfg, q, seeds, seed_d, allow = _torch_inputs(world, 0)
    calls = []
    plain = tsearch._beam_search_base_plain

    def spy(*a):
        calls.append(a[8])  # max_iters, resolved by the wrapper
        return plain(*a)

    def no_kernel(*a, **k):
        raise AssertionError("the kernel path ran for CPU tensors")

    monkeypatch.setattr(tsearch, "_beam_search_base_plain", spy)
    monkeypatch.setattr(tsearch, "_beam_search_base_cuda", no_kernel)
    before = csrc.KERNELS["beam_search"].launches
    tsearch.beam_search_base(g, cfg, q, seeds, seed_d, 16, allow, expand=2)
    assert calls == [4 + (2 * 16) // 2]
    assert csrc.KERNELS["beam_search"].launches == before


def test_shape_over_the_shared_memory_limit_raises_before_any_launch(world, monkeypatch):
    """Pools past a block's shared memory, and more neighbour slots than a
    block has threads, launch in the wide layout with a workspace of B
    queries' pools; only a query too wide for shared memory by itself
    raises, before any launch."""
    g, cfg, q, seeds, seed_d, allow = _torch_inputs(world, 0)
    launched = []
    monkeypatch.setattr(tsearch._BEAM, "launch", lambda *a: launched.append(a))
    pools = tsearch._seed_pools(q, seeds, seed_d, 16, allow)
    qn = (q * q).sum(-1)
    B = q.shape[0]

    def layout(args):  # (wide flag, smem bytes, pool bytes, workspace bytes)
        return args[-4:]

    # a shape that fits goes through to the launch in the shared layout
    tsearch._beam_launch(g, cfg, q, qn, pools, 16, allow, 1, 36, 0, True, True)
    assert len(launched) == 1
    assert layout(launched[0]) == (0, tsearch.beam_smem_bytes(16, 1, 16, D, 36, True, True), 0, 0)
    ef = 20_000
    tsearch._beam_launch(g, cfg, q, qn, tsearch._seed_pools(q, seeds, seed_d, ef, allow),
                         ef, allow, 1, 4 + 2 * ef, 0, True, True)
    sizes = (ef, 1, 16, D, 4 + 2 * ef, True, True)
    pool = tsearch.beam_pool_bytes(*sizes)
    assert tsearch.beam_smem_bytes(*sizes) > tsearch._BEAM_MAX_SMEM
    assert layout(launched[1]) == (1, tsearch.beam_smem_bytes(*sizes, wide=True), pool, B * pool)
    assert launched[1][12] is not None  # the workspace pointer
    # E * fan-out 2,048 > 256 threads: the threads stride over the slots
    fan512 = dataclasses.replace(cfg, m0=512)
    g512 = dataclasses.replace(g, adj0=torch.full((g.capacity, 512), -1, dtype=torch.int32))
    tsearch._beam_launch(g512, fan512, q, qn, pools, 16, allow, 4, 12, 0, True, True)
    assert len(launched) == 3 and layout(launched[2])[0] == 0
    huge = dataclasses.replace(cfg, dims=60_000)
    gh = dataclasses.replace(g, vectors=torch.zeros((g.capacity, 60_000)))
    with pytest.raises(ValueError, match=r"d=60000, E=1, m0=16 need \d+ bytes"):
        tsearch._beam_launch(gh, huge, torch.zeros((B, 60_000)), qn, pools, 16, allow, 1, 36,
                             0, True, True)
    assert len(launched) == 3


@pytest.mark.parametrize("ef,E,fan,d,iters,dual,hist,want", [
    # serving: query, 9 B x 128 slots, history, batch, scratch
    (64, 1, 32, 128, 132, False, True, 512 + 9 * 128 + 528 + 320 + 272),
    (64, 1, 32, 128, 132, True, True, 512 + 17 * 128 + 528 + 320 + 272),
    (64, 1, 32, 128, 132, True, False, 512 + 17 * 128 + 320 + 272),
    # a total that is rounded up to 16 bytes
    (16, 1, 32, 100, 36, False, True, (400 + 9 * 64 + 144 + 320 + 272 + 15) // 16 * 16),
    (128, 4, 32, 128, 68, False, True, 512 + 9 * 256 + 1088 + 1280 + 272),
])
def test_beam_smem_bytes(ef, E, fan, d, iters, dual, hist, want):
    assert tsearch.beam_smem_bytes(ef, E, fan, d, iters, dual, hist) == want


def test_largest_ef_that_fits():
    """At E=1, m0=32, d=128 a block's 227 KB
    hold the pools of ef = 8,160 under dual_pool (one more doubles the
    merge buffer) and of ef = 10,484 with a single pool."""
    def need(ef, dual):
        return tsearch.beam_smem_bytes(ef, 1, 32, 128, 4 + 2 * ef, dual, True)

    assert need(8160, True) <= tsearch._BEAM_MAX_SMEM < need(8161, True)
    assert need(10484, False) <= tsearch._BEAM_MAX_SMEM < need(10485, False)


def test_beam_source_is_registered():
    assert csrc.SOURCES["beam"] == "beam.cu"
    assert "gather.cuh" in csrc._HEADERS
    assert csrc.KERNELS["beam_search"].library == "beam"
