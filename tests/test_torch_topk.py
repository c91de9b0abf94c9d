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
    td, ti = ttopk._select_min_k(segmins.T.contiguous(), keep)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
