"""vss_tpu_torch.ops.scan against vss_tpu.ops.scan on the CPU.

vss_tpu runs its native scan with the TPU kernel `_native_segmin_kernel`
in interpret mode (`use_pallas` patched, as tests/test_native_scan.py
does); the port runs kernel K2's plain version. Tolerances:
  * final distances (exact f32 rerank, or exact f32 rescore without a
    rerank tape): rtol 1e-5, atol 1e-4, ids equal on tie-free data;
  * K2's bf16-proxy sub-segment minima: rtol 1e-2, and the selected
    sub-segment ids equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import vss_tpu.ops.scan as jscan
import vss_tpu_torch.ops.scan as tscan
from vss_tpu_torch.convert import tensor_from_array

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        jscan.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    import vss_tpu.utils as utils

    monkeypatch.setattr(utils, "use_pallas", lambda: True)
    jscan._native_segmin_scan.clear_cache()
    yield
    jscan._native_segmin_scan.clear_cache()


def _tape(rng, n, d, dtype):
    if dtype == "int8":
        xf = rng.integers(-127, 128, (n, d)).astype(np.float32)
        tape = jnp.asarray(xf, jnp.int8)
    else:
        tape = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32), jnp.bfloat16)
        xf = np.array(tape.astype(jnp.float32))
    return tape, xf


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("rerank", [True, False])
def test_scan_topk_matches_jax(interpret_pallas, metric, dtype, rerank):
    rng = np.random.default_rng(7)
    n, d, nq, k = 4096, 64, 12, 5
    tape, xf = _tape(rng, n, d, dtype)
    q = (rng.normal(size=(nq, d)) * 20).astype(np.float32)
    vm = np.ones(n, bool)
    vm[rng.choice(n, 200, replace=False)] = False
    rr = xf if rerank else None
    jd, ji = jscan.scan_topk(
        jnp.asarray(q), tape, k, metric, valid_mask=jnp.asarray(vm),
        rerank_tape=None if rr is None else jnp.asarray(rr),
    )
    td, ti = tscan.scan_topk(
        torch.from_numpy(q), tensor_from_array(np.asarray(tape)), k, metric,
        valid_mask=torch.from_numpy(vm),
        rerank_tape=None if rr is None else torch.from_numpy(rr), device="cpu",
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)


def test_scan_topk_keep_and_norms_match_jax(interpret_pallas):
    """The serving call: keep = 2k and a precomputed norm tape."""
    rng = np.random.default_rng(9)
    n, d, nq, k = 3000, 32, 8, 4  # ragged: 3000 is not a multiple of 128
    tape, xf = _tape(rng, n, d, "int8")
    xn = (xf * xf).sum(1)
    q = (rng.normal(size=(nq, d)) * 20).astype(np.float32)
    jd, ji = jscan.scan_topk(
        jnp.asarray(q), tape, k, "l2sq", x_norms=jnp.asarray(xn),
        rerank_tape=jnp.asarray(xf), keep=2 * k,
    )
    td, ti = tscan.scan_topk(
        torch.from_numpy(q), tensor_from_array(np.asarray(tape)), k, "l2sq",
        x_norms=torch.from_numpy(xn), rerank_tape=torch.from_numpy(xf), keep=2 * k,
        device="cpu",
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)


def test_scan_topk_small_falls_back_to_oracle():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    d, i = tscan.scan_topk(torch.from_numpy(x[:4]), torch.from_numpy(x), 1, "l2sq",
                           device="cpu")
    assert (i.numpy()[:, 0] == np.arange(4)).all()


def _jax_submins(q_bf16, tape, xn, valid, metric):
    """The TPU kernel's raw [nx/32, nq] sub-minima, in interpret mode."""
    nq, d = q_bf16.shape
    nx = tape.shape[0]
    tile, subt = 1024, 1
    return pl.pallas_call(
        functools.partial(jscan._native_segmin_kernel, metric_name=metric, subt=subt),
        grid=(1, nx // tile),
        in_specs=[
            pl.BlockSpec((nq, d), lambda i, j: (i, 0)),
            pl.BlockSpec((tile, d), lambda i, j: (j, 0)),
            pl.BlockSpec((tile, 1), lambda i, j: (j, 0)),
            pl.BlockSpec((tile, 1), lambda i, j: (j, 0)),
        ],
        out_specs=pl.BlockSpec((tile // 32, nq), lambda i, j: (j, i)),
        out_shape=jax.ShapeDtypeStruct((nx // 32, nq), jnp.float32),
        interpret=True,
    )(q_bf16, tape, xn[:, None], valid.astype(jnp.int32)[:, None])


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_k2_plain_matches_pallas_kernel(interpret_pallas, metric, dtype):
    rng = np.random.default_rng(11)
    n, d, nq, keep = 2048, 64, 8, 6
    tape, xf = _tape(rng, n, d, dtype)
    xf[9] = 0.0  # a zero row under cosine proxies to 0
    tape = jnp.asarray(xf, tape.dtype)
    xn = (xf * xf).sum(1).astype(np.float32)
    vm = rng.random(n) > 0.1
    q = (rng.normal(size=(nq, d)) * 20).astype(np.float32)
    qb = jnp.asarray(q, jnp.bfloat16)
    want = np.asarray(_jax_submins(qb, tape, jnp.asarray(xn), jnp.asarray(vm), metric))
    got = tscan.native_segmin(
        tensor_from_array(np.asarray(qb)), tensor_from_array(np.asarray(tape)),
        torch.from_numpy(xn), torch.from_numpy(vm), metric,
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-2)
    # the selection the scan makes from them is the same
    want_ids = np.asarray(jscan._native_segmin_scan(
        qb, tape, jnp.asarray(xn)[:, None], jnp.asarray(vm, jnp.int32)[:, None],
        keep, metric, 1024, nq, 1,
    ))
    got_ids = tscan._select_subsegments(got, keep).numpy()
    np.testing.assert_array_equal(got_ids, want_ids)


def _recall(got, truth):
    return float(np.mean([len(set(g) & set(t)) / len(t) for g, t in zip(got, truth)]))


@pytest.mark.parametrize("n,k,keep,diverges", [
    (3000, 128, None, True), (4096, 100, 200, True), (8192, 100, 200, True),
    (20_000, 100, 200, False)])
def test_scan_topk_keep_cap_diverges_from_jax_on_small_tapes(interpret_pallas, n, k, keep,
                                                              diverges):
    """The port caps `keep` at the tape's 32-row subs, the reference at its
    128-row supers (`vss_tpu/ops/scan.py:401-402`), which breaks the bound
    of at most k segments holding the true top-k. On small tapes at large k
    the port then equals the exact oracle and the reference falls short of
    it; at 20,000 rows the two caps do not bind and the outputs agree."""
    from vss_tpu_torch.ops.topk import bruteforce_topk

    rng = np.random.default_rng(3)
    d = 32
    xf = rng.integers(-127, 128, (n, d)).astype(np.float32)
    q = (rng.normal(size=(4, d)) * 20).astype(np.float32)
    _, ji = jscan.scan_topk(jnp.asarray(q), jnp.asarray(xf, jnp.int8), k, "l2sq",
                            rerank_tape=jnp.asarray(xf), keep=keep)
    _, ti = tscan.scan_topk(torch.from_numpy(q), torch.from_numpy(xf).to(torch.int8), k, "l2sq",
                            rerank_tape=torch.from_numpy(xf), keep=keep, device="cpu")
    _, oi = bruteforce_topk(torch.from_numpy(q), torch.from_numpy(xf), k, "l2sq", device="cpu")
    ti, ji, oi = ti.numpy(), np.asarray(ji), oi.numpy()
    assert _recall(ti, oi) == 1.0
    if diverges:
        assert _recall(ji, oi) < 0.9
    else:
        np.testing.assert_array_equal(ti, ji)
