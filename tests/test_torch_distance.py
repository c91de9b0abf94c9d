"""vss_tpu_torch.ops.distance against vss_tpu.ops.distance on the CPU.

The same numpy inputs go through both packages. Kernel K4's plain
version (`pairwise`, what `dispatch_pairwise` runs on CPU tensors) is
held against the TPU kernel `_pairwise_kernel` in interpret mode.
Tolerance for these f32-exact paths: rtol 1e-5, atol 1e-4 (summation
order differs between XLA and PyTorch).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import vss_tpu.ops.distance as jdist
import vss_tpu_torch.ops.distance as tdist

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        jdist.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    jdist._pairwise_pallas_padded.clear_cache()
    yield
    jdist._pairwise_pallas_padded.clear_cache()


def _inputs(nq=10, nx=700, d=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    x = rng.normal(size=(nx, d)).astype(np.float32)
    q[1] = 0.0  # zero vectors exercise the cosine guards
    x[3] = 0.0
    return q, x


@pytest.mark.parametrize("name,expected", [
    ("l2sq", "L2SQ"), ("L2", "L2SQ"), ("euclidean", "L2SQ"),
    ("cosine", "COSINE"), ("cos", "COSINE"), ("ip", "IP"),
    ("innerproduct", "IP"), ("inner_product", "IP"),
])
def test_metric_aliases(name, expected):
    assert tdist.Metric.parse(name) is tdist.Metric[expected]
    assert tdist.Metric.parse(name).value == jdist.Metric.parse(name).value


def test_metric_error_text_matches():
    with pytest.raises(ValueError) as tex:
        tdist.Metric.parse("hamming")
    with pytest.raises(ValueError) as jex:
        jdist.Metric.parse("hamming")
    assert str(tex.value) == str(jex.value)


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_pairwise_matches_jax(metric):
    q, x = _inputs()
    want = np.asarray(jdist.pairwise(jnp.asarray(q), jnp.asarray(x), metric))
    got = tdist.pairwise(torch.from_numpy(q), torch.from_numpy(x), metric).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if metric == "cosine":
        assert got[1, 3] == 0.0 and got[1, 0] == 1.0 and got[0, 3] == 1.0


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_k4_plain_matches_pallas_kernel(interpret_pallas, metric):
    q, x = _inputs(seed=1)
    want = np.asarray(jdist.pairwise_pallas(jnp.asarray(q), jnp.asarray(x), metric))
    got = tdist.dispatch_pairwise(torch.from_numpy(q), torch.from_numpy(x), metric)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
@pytest.mark.parametrize("norms", [False, True])
def test_gathered_distances_matches_jax(metric, norms):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(6, 32)).astype(np.float32)
    cv = rng.normal(size=(6, 9, 32)).astype(np.float32)
    cv[0, 0] = 0.0
    q[2] = 0.0
    cn = (cv * cv).sum(-1) if norms else None
    qn = (q * q).sum(-1) if norms else None
    want = np.asarray(jdist.gathered_distances(
        jnp.asarray(q), jnp.asarray(cv), metric,
        None if cn is None else jnp.asarray(cn),
        None if qn is None else jnp.asarray(qn),
    ))
    got = tdist.gathered_distances(
        torch.from_numpy(q), torch.from_numpy(cv), metric,
        None if cn is None else torch.from_numpy(cn),
        None if qn is None else torch.from_numpy(qn),
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_distance_one():
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = np.array([2.0, 0.0, 3.0], np.float32)
    got = float(tdist.distance_one(torch.from_numpy(a), torch.from_numpy(b), "l2sq"))
    assert got == pytest.approx(float(jdist.distance_one(jnp.asarray(a), jnp.asarray(b), "l2sq")))
