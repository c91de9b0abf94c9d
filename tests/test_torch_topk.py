"""vss_tpu_torch.ops.topk against vss_tpu.ops.topk on the CPU.

`bruteforce_topk` is the exact oracle: ids must be equal on tie-free
data and distances within rtol 1e-5, atol 1e-4 (summation order). The
port runs its winnow path (kernel K3's plain version) where vss_tpu on
the CPU runs its chunked XLA path, so these tests also hold the two
algorithms against each other. K3's plain version is held against the
TPU kernel `_scan_segmin_kernel` in interpret mode.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import vss_tpu.ops.topk as jtopk
import vss_tpu_torch.ops.topk as ttopk

RTOL, ATOL = 1e-5, 1e-4


def _both(q, x, k, metric, vm=None, **kw):
    jd, ji = jtopk.bruteforce_topk(
        jnp.asarray(q), jnp.asarray(x), k, metric,
        valid_mask=None if vm is None else jnp.asarray(vm), **kw,
    )
    td, ti = ttopk.bruteforce_topk(
        torch.from_numpy(q), torch.from_numpy(x), k, metric,
        valid_mask=None if vm is None else torch.from_numpy(vm), device="cpu", **kw,
    )
    return (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy())


def _check(j, t):
    np.testing.assert_array_equal(t[1], j[1])
    fin = np.isfinite(j[0])
    np.testing.assert_array_equal(np.isfinite(t[0]), fin)
    np.testing.assert_allclose(t[0][fin], j[0][fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_bruteforce_matches_jax_with_mask(metric):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(16, 48)).astype(np.float32)
    x = rng.normal(size=(1500, 48)).astype(np.float32)
    x[5] = 0.0
    vm = rng.random(1500) > 0.25
    j, t = _both(q, x, 10, metric, vm)
    _check(j, t)


def test_bruteforce_k_past_n_and_nan_query():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(8, 32)).astype(np.float32)
    q[2] = np.nan
    x = rng.normal(size=(12, 32)).astype(np.float32)
    j, t = _both(q, x, 16, "l2sq")
    _check(j, t)
    assert np.all(t[1][2] == -1) and not np.isfinite(t[0][2]).any()
    assert np.all(t[1][:, 12:] == -1)


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_bruteforce_nan_query_on_winnow_path(metric):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(4, 16)).astype(np.float32)
    q[1] = np.nan
    x = rng.normal(size=(900, 16)).astype(np.float32)
    j, t = _both(q, x, 5, metric)
    _check(j, t)
    if metric != "cosine":  # the cosine guards map a NaN norm to distance 1
        assert np.all(t[1][1] == -1)


@pytest.mark.parametrize("metric", ["l2sq", "ip"])
def test_bruteforce_k80_chunked_path(metric):
    rng = np.random.default_rng(6)
    q = rng.normal(size=(6, 24)).astype(np.float32)
    x = rng.normal(size=(1300, 24)).astype(np.float32)
    vm = rng.random(1300) > 0.1
    j, t = _both(q, x, 80, metric, vm, chunk=512)
    _check(j, t)


def test_bruteforce_empty_and_all_masked():
    q = np.ones((2, 8), np.float32)
    td, ti = ttopk.bruteforce_topk(torch.from_numpy(q), torch.zeros((0, 8)), 3, "l2sq",
                                     device="cpu")
    assert (ti.numpy() == -1).all() and not torch.isfinite(td).any()
    x = np.random.default_rng(0).normal(size=(600, 8)).astype(np.float32)
    j, t = _both(q, x, 4, "l2sq", np.zeros(600, bool))
    _check(j, t)
    assert (t[1] == -1).all()


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(7)
    d = rng.random((5, 12)).astype(np.float32)
    i = rng.integers(0, 100, (5, 12)).astype(np.int32)
    jd, ji = jtopk.merge_topk(jnp.asarray(d), jnp.asarray(i), 4)
    td, ti = ttopk.merge_topk(torch.from_numpy(d), torch.from_numpy(i), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd))


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        jtopk.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    jtopk._segmin_scan_pallas.clear_cache()
    yield
    jtopk._segmin_scan_pallas.clear_cache()


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_k3_plain_matches_pallas_kernel(interpret_pallas, metric):
    """Segment minima of K3's plain version vs the TPU kernel's selected
    segments: the keep smallest minima and their segment ids."""
    rng = np.random.default_rng(8)
    nq, nx, d, keep = 8, 1800, 64, 6
    q = rng.normal(size=(nq, d)).astype(np.float32)
    x = rng.normal(size=(nx, d)).astype(np.float32)
    x[7] = 0.0
    vm = rng.random(nx) > 0.2
    tile, subt = 1024, 2
    xp = np.zeros((2048, d), np.float32)
    xp[:nx] = x
    vp = np.zeros(2048, np.int32)
    vp[:nx] = vm
    qn = (q * q).sum(1, keepdims=True)
    jd, ji = jtopk._segmin_scan_pallas(
        jnp.asarray(q), jnp.asarray(qn), jnp.asarray(xp), jnp.asarray(vp)[None, :],
        keep, metric, tile, nq, True, subt,
    )
    segmins = ttopk.segmin_scan(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(vm), metric
    )
    assert segmins.shape == (15, nq)  # ceil(1800 / 128)
    td, ti = ttopk.select_k(segmins.T.contiguous(), keep)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
@pytest.mark.parametrize("k,nx,chunk", [(20, 500, 128), (80, 1250, 384), (100, 1250, 384)])
def test_bruteforce_chunked_merge_of_each_chunks_k_least(monkeypatch, metric, k, nx, chunk):
    """The chunked path takes each chunk's stable k least (`select_k`, with
    the tombstones and NaN read as +inf: here its plain version, in the
    argmin order at k=20 and the sort's at 80 and 100) and merges them
    with the running best; it must equal vss_tpu's chunked path over four
    chunks, the last shorter than k at k=100, with a NULL query and
    tombstones."""
    rng = np.random.default_rng(9)
    q = rng.normal(size=(5, 24)).astype(np.float32)
    q[3] = np.nan
    x = rng.normal(size=(nx, 24)).astype(np.float32)
    x[11] = x[10]  # a tie across rows
    vm = rng.random(nx) > 0.15
    calls = []
    select_k = ttopk.select_k

    def spy(d, kk, valid=None, nan_as_inf=False):
        calls.append((tuple(d.shape), kk, valid is not None, nan_as_inf))
        return select_k(d, kk, valid, nan_as_inf)

    monkeypatch.setattr(ttopk, "select_k", spy)
    j, t = _both(q, x, k, metric, vm, chunk=chunk)
    _check(j, t)
    sizes = [chunk] * 3 + [nx - 3 * chunk]
    assert calls == [((5, n), min(k, n), True, True) for n in sizes]
    if metric != "cosine":  # the cosine guards map a NaN norm to distance 1
        assert np.all(t[1][3] == -1)


def _edge_rows(seed, R, C):
    """Small integers (many ties) with +-0, +-inf and NaN among them, a row
    of NaN and a row of +inf."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (R, C)).astype(np.float32)
    u = rng.random((R, C))
    x[u < 0.1] = -0.0
    x[(u >= 0.1) & (u < 0.2)] = 0.0
    x[(u >= 0.2) & (u < 0.25)] = np.inf
    x[(u >= 0.25) & (u < 0.28)] = -np.inf
    x[(u >= 0.28) & (u < 0.32)] = np.nan
    x[1] = np.nan
    x[2] = np.inf
    return x


@pytest.mark.parametrize("k", [1, 4, 12, 20, 32])
def test_select_min_k_plain_matches_jax_iter_min_k(k):
    """k <= 32: the k argmin passes of both packages, bit for bit: NaN
    first by position, ties (and -0 with +0) to the lower position, then
    (+inf, 0) once a row's other values are used up."""
    x = _edge_rows(k, 6, 96)
    jv, ji = jtopk._iter_min_k(jnp.asarray(x), k)
    tv, ti = ttopk._select_min_k_plain(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))


def _stable_order(x, zero_sign: bool):
    """Positions of each row of x by (NaN last, value, [-0 before +0],
    position)."""
    pos = np.broadcast_to(np.arange(x.shape[1]), x.shape)
    nan = np.isnan(x)
    keys = (pos, ~np.signbit(x) if zero_sign else np.zeros(x.shape, bool),
            np.where(nan, np.inf, x), nan)
    return np.stack([np.lexsort(tuple(k[r] for k in keys)) for r in range(x.shape[0])])


@pytest.mark.parametrize("k", [33, 60, 96])
def test_select_min_k_plain_against_jax_top_k(k):
    """k > 32: the port's stable sort against vss_tpu's `lax.top_k` of the
    negated values (`vss_tpu/ops/scan.py:_select_min_k`). Both put NaN last
    and +inf before it by position, and break ties of equal values by
    position; they differ only on zeros: `lax.top_k` orders -0 before +0
    (a total order on the negated values), the stable sort takes -0 and
    +0 as equal, by position. Each is held to its own order, and on rows
    whose zeros share one sign the two are equal bit for bit."""
    import vss_tpu.ops.scan as jscan

    x = _edge_rows(k, 6, 96)
    x[3] = np.abs(x[3])  # zeros of one sign
    jv, ji = (np.asarray(a) for a in jscan._select_min_k(jnp.asarray(x), k))
    tv, ti = (a.numpy() for a in ttopk._select_min_k_plain(torch.from_numpy(x), k))
    rows = np.arange(x.shape[0])[:, None]
    np.testing.assert_array_equal(ti, _stable_order(x, False)[:, :k])
    np.testing.assert_array_equal(ji, _stable_order(x, True)[:, :k])
    np.testing.assert_array_equal(tv.view(np.int32), x[rows, ti].view(np.int32))
    np.testing.assert_array_equal(jv.view(np.int32), x[rows, ji].view(np.int32))
    np.testing.assert_array_equal(ti[2:4], ji[2:4])  # a row of +inf; one sign of zero
    np.testing.assert_array_equal(tv[2:4].view(np.int32), jv[2:4].view(np.int32))
