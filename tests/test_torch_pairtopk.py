"""`_pairwise_topk_plain`, the plain version of the `pairwise_topk` kernel,
against `vss_tpu`'s `bruteforce_topk` on its chunked path, on the CPU.

The same numpy inputs go through both: real-valued queries and rows from a
seed, with tombstones, a NULL (NaN) query, zero vectors and rows repeated
(ties, which go to the lower row in both packages). Ids must be equal and
distances within rtol 1e-5, atol 1e-4 (the two packages sum in another
order), as in `tests/test_torch_topk.py`'s chunked tests; the slots past
the candidates are (+inf, -1) in both. The chunk sizes differ on purpose:
the stable k least do not depend on them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vss_tpu.ops.topk as jtopk
import vss_tpu_torch.ops.topk as ttopk

RTOL, ATOL = 1e-5, 1e-4


def _inputs(seed, nq, nx, d, masked=True):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    x = rng.normal(size=(nx, d)).astype(np.float32)
    x[11] = x[10]  # a tie between neighbouring rows
    x[nx - 1] = x[3]  # and across the tape
    x[7] = 0.0
    q[1] = np.nan  # a NULL query
    q[2] = 0.0
    q[3] = x[10] + 1e-3  # the tie among its nearest
    q[4] = x[3] + 1e-3
    vm = rng.random(nx) > 0.15 if masked else np.ones(nx, bool)
    vm[[3, 10, 11, nx - 1]] = True
    return q, x, vm


def _check(j, t):
    np.testing.assert_array_equal(t[1], j[1])
    fin = np.isfinite(j[0])
    np.testing.assert_array_equal(np.isfinite(t[0]), fin)
    np.testing.assert_allclose(t[0][fin], j[0][fin], rtol=RTOL, atol=ATOL)


def _both(q, x, k, metric, vm, jchunk, tchunk=None):
    jd, ji = jtopk.bruteforce_topk(jnp.asarray(q), jnp.asarray(x), k, metric,
                                   valid_mask=jnp.asarray(vm), chunk=jchunk)
    td, ti = ttopk._pairwise_topk_plain(torch.from_numpy(q), torch.from_numpy(x), k, metric,
                                        torch.from_numpy(vm), chunk=tchunk)
    return (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy())


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
@pytest.mark.parametrize("k,nx,jchunk,tchunk", [
    (100, 1300, 512, None),  # the kernel's k; one chunk here, three there
    (256, 1100, 384, 300),  # the widest k the kernel takes
    (33, 900, 256, 512),
    (1, 700, 128, None),
])
def test_pairwise_topk_plain_matches_jax_chunked_oracle(metric, k, nx, jchunk, tchunk):
    q, x, vm = _inputs(k + nx, 9, nx, 24)
    j, t = _both(q, x, k, metric, vm, jchunk, tchunk)
    _check(j, t)
    if metric != "cosine":  # the cosine guards map a NaN norm to distance 1
        assert np.all(t[1][1] == -1)
    if k > 1:
        assert 10 in t[1][3] and 11 in t[1][3]
        assert list(t[1][3]).index(10) < list(t[1][3]).index(11)


@pytest.mark.parametrize("metric", ["l2sq", "ip"])
def test_pairwise_topk_plain_k_past_the_rows_matches_jax(metric):
    """k above the rows the mask keeps: the slots past them are (+inf, -1)
    in both packages."""
    q, x, vm = _inputs(3, 6, 150, 16)
    j, t = _both(q, x, 200, metric, vm, 128, 64)
    _check(j, t)
    kept = int(vm.sum())
    assert np.all(t[1][[0, 2, 3, 4, 5], kept:] == -1)


def test_pairwise_topk_plain_all_masked_matches_jax():
    q, x, _ = _inputs(4, 5, 600, 16)
    j, t = _both(q, x, 40, "l2sq", np.zeros(600, bool), 256)
    _check(j, t)
    assert np.all(t[1] == -1) and not np.isfinite(t[0]).any()


def test_pairwise_topk_on_cpu_matches_jax_bruteforce():
    """The public wrapper on CPU tensors (its plain version) against
    `vss_tpu`'s chunked oracle at its default chunk."""
    q, x, vm = _inputs(5, 7, 1000, 32)
    jd, ji = jtopk.bruteforce_topk(jnp.asarray(q), jnp.asarray(x), 100, "cosine",
                                   valid_mask=jnp.asarray(vm))
    td, ti = ttopk.pairwise_topk(torch.from_numpy(q), torch.from_numpy(x), 100, "cosine",
                                 torch.from_numpy(vm))
    _check((np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy()))
