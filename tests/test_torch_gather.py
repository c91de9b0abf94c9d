"""Kernel K1's plain version against the TPU kernel `_gather_dist_kernel`
(interpret mode) on the CPU.

The JAX kernel takes the i32-word packed table (`pack_table`); the port
takes the table in its own dtype. Tolerance: rtol 1e-5, atol 1e-4 (f32
sums in another order).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import vss_tpu.ops.gather as jgather
from vss_tpu_torch.convert import tensor_from_array
from vss_tpu_torch.ops.gather import gather_distances

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        jgather.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    jgather._gather_distances_impl.clear_cache()
    yield
    jgather._gather_distances_impl.clear_cache()


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
@pytest.mark.parametrize("dtype,d", [("f32", 128), ("bf16", 256), ("int8", 512)])
def test_k1_plain_matches_pallas_kernel(interpret_pallas, metric, dtype, d):
    rng = np.random.default_rng(1)
    B, C, n = 8, 20, 300
    if dtype == "int8":
        table_j = jnp.asarray(rng.integers(-100, 100, (n, d)).astype(np.int8))
    else:
        jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
        table_j = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32), jdt)
    table_np = np.array(table_j)
    table_np[5] = 0  # a zero row exercises the cosine guard
    table_j = jnp.asarray(table_np)
    if dtype == "int8":
        # integer queries keep every int8 dot exact in f32, so the order of
        # the 512-term sums cannot matter
        q = rng.integers(-10, 10, (B, d)).astype(np.float32)
    else:
        q = (rng.normal(size=(B, d)) * 10).astype(np.float32)
    q[3] = 0.0
    ids = rng.integers(0, n, (B, C)).astype(np.int32)
    ids[0, :4] = -1  # sentinels: no load, +inf
    ids[1, 0] = 5
    packed, p = jgather.pack_table(table_j)
    want = np.asarray(jgather.gather_distances_pallas(
        packed, jnp.asarray(ids), jnp.asarray(q), metric, packing=p,
    ))
    got = gather_distances(
        tensor_from_array(table_np), torch.from_numpy(ids), torch.from_numpy(q), metric
    ).numpy()
    assert not np.isfinite(got[0, :4]).any()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def test_k1_takes_given_query_norms():
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.normal(size=(50, 16)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-1, 50, (3, 7)).astype(np.int32))
    a = gather_distances(table, ids, q, "l2sq")
    b = gather_distances(table, ids, q, "l2sq", (q * q).sum(-1))
    torch.testing.assert_close(a, b)


def test_kernels_refuse_cpu_tensors_and_count_nothing():
    from vss_tpu_torch import csrc

    for kernel in csrc.KERNELS.values():
        before = kernel.launches
        with pytest.raises(ValueError, match="one CUDA device"):
            kernel.launch((torch.zeros(4),))
        assert kernel.launches == before
    assert sorted(csrc.KERNELS) == [
        "gather_distances", "native_segmin", "pairwise", "scan_segmin"]
