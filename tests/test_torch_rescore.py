"""Phases B and C of the exact scan: the port's plain version
(`vss_tpu_torch.ops.scan._rescore_plain`, the rescore_topk kernel's
reference) against `vss_tpu.ops.scan._rescore_native_block` on the CPU.

The JAX side is plain XLA there (no Pallas). Both take the same numpy
inputs: a tape padded to a multiple of 32 rows (the JAX package views it
as 32-row blocks), sub-segment ids with -1 padding, invalid rows, an f32
or bf16 rerank tape or none. Real-valued data: the two sum in other
orders, so distances agree within 1e-5 of their magnitude and ids are
equal except at a near-tie (a neighbouring distance within that
tolerance). The file also holds the wrapper's routing on the CPU (CPU
tensors run the plain version, chunk by chunk, and launch nothing) and
`scan_topk`'s CPU outputs to the parent's composition (phase A, the
selections, then the chunk loop over `_rescore_plain`), bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vss_tpu.ops.scan as jscan
import vss_tpu_torch.ops.scan as tscan
from vss_tpu_torch.convert import tensor_from_array
from vss_tpu_torch.ops.distance import Metric

REL_TOL = 1e-5

_JNP = {"int8": jnp.int8, "bf16": jnp.bfloat16, "f32": jnp.float32}


def _inputs(seed, nq, nx, d, keep, dtype, rr_dtype):
    """(q, segs, tape, x_norms, valid, rerank tape or None) as JAX arrays:
    an int8 tape of integers, or real values for bf16 / f32; the rerank
    tape the tape's values plus noise; queries near tape rows."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        x = rng.integers(-127, 128, (nx, d)).astype(np.float32)
    else:
        x = (rng.normal(size=(nx, d)) * 20).astype(np.float32)
    tape = jnp.asarray(x, _JNP[dtype])
    xf = np.asarray(tape.astype(jnp.float32))
    q = (xf[rng.integers(0, nx, nq)] + rng.normal(size=(nq, d)) * 8).astype(np.float32)
    valid = rng.random(nx) > 0.1
    nsub = nx // 32
    segs = np.stack([rng.choice(nsub, keep, replace=False) for _ in range(nq)]).astype(np.int32)
    segs[rng.random(segs.shape) < 0.15] = -1
    rr = None
    if rr_dtype is not None:
        rr = jnp.asarray(xf + rng.normal(size=xf.shape).astype(np.float32), _JNP[rr_dtype])
    return (jnp.asarray(q), jnp.asarray(segs), tape, jnp.asarray((xf * xf).sum(1)),
            jnp.asarray(valid), rr)


def _torch(a):
    return None if a is None else tensor_from_array(np.asarray(a))


def _near_ties(d: np.ndarray, tol: float) -> np.ndarray:
    """Places of each row whose distance is within `tol` of a neighbour's."""
    gap = np.abs(np.diff(d, axis=1)) <= tol
    near = np.zeros(d.shape, bool)
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    return near


@pytest.mark.parametrize("rr_dtype", ["f32", "bf16", None])
@pytest.mark.parametrize("dtype", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_rescore_plain_matches_jax(metric, dtype, rr_dtype):
    for seed, (k, keep) in enumerate(((10, 12), (40, 16), (3, 1))):
        nq, nx, d = 6, 32 * 40, 48
        args = _inputs(seed, nq, nx, d, keep, dtype, rr_dtype)
        q, segs, tape, xn, valid, rr = args
        m = min(max(2 * k, k + 6), keep * 32) if rr is not None else k
        jd, ji = jscan._rescore_native_block(q, segs, tape, xn, valid, rr, m, k, metric,
                                             rr is not None)
        td, ti = tscan._rescore_plain(*(_torch(a) for a in args), m, k, Metric.parse(metric))
        jd, ji = np.asarray(jd), np.asarray(ji)
        td, ti = td.numpy(), ti.numpy()
        assert td.shape == ti.shape == (nq, k) and ti.dtype == np.int32
        fin = np.isfinite(jd)
        np.testing.assert_array_equal(np.isfinite(td), fin)
        scale = float(np.abs(jd[fin]).max()) if fin.any() else 1.0
        np.testing.assert_allclose(td[fin], jd[fin], rtol=0, atol=REL_TOL * scale)
        differ = ti != ji
        assert not (differ & ~_near_ties(jd, REL_TOL * scale)).any(), (metric, dtype, k)


def test_rescore_topk_runs_the_plain_version_on_cpu_tensors(monkeypatch):
    """CPU tensors: `_rescore_plain` chunk by chunk, no launch, no count."""
    q, segs, tape, xn, valid, rr = (_torch(a) for a in _inputs(1, 9, 32 * 40, 48, 12, "int8",
                                                               "f32"))

    def refuse(*a, **kw):
        raise AssertionError("the kernel's launch ran on CPU tensors")

    calls = []
    plain = tscan._rescore_plain

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return plain(*a, **kw)

    monkeypatch.setattr(tscan, "_rescore_launch", refuse)
    monkeypatch.setattr(tscan, "_rescore_plain", counted)
    before = tscan._RESCORE.launches
    got = tscan.rescore_topk(q, segs, tape, xn, valid, rr, 20, 10, "l2sq")
    assert calls == [9] and tscan._RESCORE.launches == before
    # query chunks of the gathered block's budget: the same outputs
    monkeypatch.setattr(tscan, "_BLOCK_ELEMS", 12 * 32 * 48 * 4)
    calls.clear()
    chunked = tscan.rescore_topk(q, segs, tape, xn, valid, rr, 20, 10, "l2sq")
    assert calls == [4, 4, 1]
    for a, b in zip(got, chunked):
        assert torch.equal(a, b)


def test_rescore_topk_pads_past_the_candidates_and_takes_no_queries():
    """keep = 1 (32 candidates) at k = 40: 40 columns, +inf and -1 past the
    pool; no queries: empty [0, k] outputs."""
    q, segs, tape, xn, valid, rr = (_torch(a) for a in _inputs(2, 3, 32 * 40, 48, 1, "int8",
                                                               None))
    d, i = tscan.rescore_topk(q, segs, tape, xn, valid, None, 40, 40, "l2sq")
    assert d.shape == i.shape == (3, 40)
    assert bool(torch.isinf(d[:, 32:]).all()) and bool((i[:, 32:] == -1).all())
    d, i = tscan.rescore_topk(q[:0], segs[:0], tape, xn, valid, rr, 20, 10, "l2sq")
    assert d.shape == i.shape == (0, 10)


def _parent_scan_topk(q, tape, k, metric, valid, xn, rr, keep):
    """The parent's scan_topk after its set-up: phase A, the selections,
    then `_rescore_plain` over query chunks."""
    metric = Metric.parse(metric)
    keep = min(keep, tscan._GROUP * -(-tape.shape[0] // tscan._SEG))
    subs = tscan.native_segmin(q.to(torch.bfloat16), tape, xn, valid, metric)
    segs = tscan._select_subsegments(subs, keep)
    m = min(max(2 * k, k + 6), segs.shape[1] * 32) if rr is not None else k
    cq = max(1, tscan._BLOCK_ELEMS // max(segs.shape[1] * 32 * q.shape[1], 1))
    parts = [tscan._rescore_plain(q[s:s + cq], segs[s:s + cq], tape, xn, valid, rr, m, k, metric)
             for s in range(0, q.shape[0], cq)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


@pytest.mark.parametrize("rerank", [True, False])
@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_scan_topk_on_the_cpu_is_unchanged(metric, rerank):
    rng = np.random.default_rng(5)
    nx, d, nq, k = 3000, 32, 7, 12
    x = rng.integers(-127, 128, (nx, d)).astype(np.float32)
    tape = torch.from_numpy(x).to(torch.int8)
    rr = torch.from_numpy(x + rng.normal(size=x.shape).astype(np.float32)) if rerank else None
    q = torch.from_numpy((x[rng.integers(0, nx, nq)] + rng.normal(size=(nq, d)) * 9)
                         .astype(np.float32))
    valid = torch.from_numpy(rng.random(nx) > 0.05)
    xn = (tape.float() ** 2).sum(1)
    got = tscan.scan_topk(q, tape, k, metric, valid_mask=valid, x_norms=xn, rerank_tape=rr,
                          keep=2 * k, device="cpu")
    want = _parent_scan_topk(q, tape, k, metric, valid, xn, rr, 2 * k)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
