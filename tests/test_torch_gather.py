"""The plain versions of kernels K1 and K5 against the TPU kernels
`_gather_dist_kernel` and `_gather_kernel` (interpret mode) on the CPU.

K1: the JAX kernel takes the i32-word packed table (`pack_table`); the
port takes the table in its own dtype. Tolerance: rtol 1e-5, atol 1e-4
(f32 sums in another order). K5 is a copy of bytes: equal bit for bit to
`gather_rows_pallas` and to `jnp.take`.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import vss_tpu.ops.gather as jgather
from vss_tpu_torch.convert import tensor_from_array
from vss_tpu_torch.ops.gather import _gather_rows_plain, gather_distances, gather_rows

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        jgather.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    jgather._gather_distances_impl.clear_cache()
    jgather._gather_rows_impl.clear_cache()
    yield
    jgather._gather_distances_impl.clear_cache()
    jgather._gather_rows_impl.clear_cache()


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
        "beam_search", "gather_distances", "gather_rows", "greedy_descent", "native_segmin",
        "pairwise", "scan_segmin"]


def _table(rng, dtype, n, row):
    """(numpy table, its bit pattern for comparisons)."""
    if dtype == "int8":
        t = rng.integers(-128, 128, (n, row)).astype(np.int8)
    elif dtype == "int32":
        t = rng.integers(-1, 10_000, (n, row)).astype(np.int32)
    elif dtype == "bf16":
        t = np.array(jnp.asarray(rng.normal(size=(n, row)).astype(np.float32), jnp.bfloat16))
    else:
        t = rng.normal(size=(n, row)).astype(np.float32)
    return t


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _torch_bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype,row", [
    ("f32", 128), ("bf16", 128), ("int8", 128), ("int32", 128), ("int8", 512)])
def test_k5_plain_matches_pallas_kernel(interpret_pallas, dtype, row):
    rng = np.random.default_rng(3)
    n = 300
    table = _table(rng, dtype, n, row)
    ids = rng.integers(0, n, 96).astype(np.int32)
    ids[:3] = -1  # clamped to row 0
    ids[10:14] = ids[9]  # repeated
    want = jgather.gather_rows_pallas(jnp.asarray(table), jnp.asarray(ids))
    got = gather_rows(tensor_from_array(table), torch.from_numpy(ids))
    assert got.shape == (96, row)
    np.testing.assert_array_equal(_torch_bits(got), _bits(want))
    np.testing.assert_array_equal(_torch_bits(got[:3]), _bits(table[[0, 0, 0]]))


@pytest.mark.parametrize("dtype,row", [("f32", 128), ("int32", 128)])
def test_k5_plain_skip_neg_matches_pallas_kernel(interpret_pallas, dtype, row):
    """With skip_neg the TPU kernel leaves the rows of negative ids
    undefined and the port makes them zeros: compare where id >= 0."""
    rng = np.random.default_rng(4)
    n = 200
    table = _table(rng, dtype, n, row)
    ids = rng.integers(-1, n, 80).astype(np.int32)
    ids[5] = -1
    want = np.asarray(jgather.gather_rows_pallas(
        jnp.asarray(table), jnp.asarray(ids), skip_neg=True))
    got = gather_rows(tensor_from_array(table), torch.from_numpy(ids), skip_neg=True).numpy()
    live = ids >= 0
    np.testing.assert_array_equal(got[live], want[live])
    assert not got[~live].any()


@pytest.mark.parametrize("dtype,row", [
    ("f32", 100), ("bf16", 24), ("int8", 100), ("int32", 32), ("int32", 6)])
def test_k5_plain_matches_jnp_take(dtype, row):
    """Any row width and ids of any shape, as the call sites of the write
    path have them (`jnp.take(table, jnp.maximum(ids, 0), axis=0)`)."""
    rng = np.random.default_rng(5)
    n = 150
    table = _table(rng, dtype, n, row)
    ids = rng.integers(-1, n, (7, 11)).astype(np.int32)
    want = jnp.take(jnp.asarray(table), jnp.maximum(jnp.asarray(ids), 0), axis=0)
    t = tensor_from_array(table)
    got = gather_rows(t, torch.from_numpy(ids))
    assert got.shape == (7, 11, row) and got.dtype == t.dtype
    np.testing.assert_array_equal(_torch_bits(got), _bits(want))
    # the dispatcher of the JAX package gives the same off the TPU
    want2 = jgather.gather_rows(jnp.asarray(table), jnp.asarray(ids.reshape(-1)))
    np.testing.assert_array_equal(_torch_bits(got).reshape(-1, row), _bits(want2))


def test_k5_edges():
    rng = np.random.default_rng(6)
    table = torch.from_numpy(rng.normal(size=(20, 8)).astype(np.float32))
    assert gather_rows(table, torch.zeros((0,), dtype=torch.int32)).shape == (0, 8)
    one = gather_rows(table, torch.tensor([19]))
    assert torch.equal(one, table[19:20])
    down = torch.arange(19, -1, -1, dtype=torch.int32)
    assert torch.equal(gather_rows(table, down), table.flip(0))
    int64_ids = torch.tensor([[3, -1], [-5, 3]])
    out = gather_rows(table, int64_ids, skip_neg=True)
    assert torch.equal(out, _gather_rows_plain(table, int64_ids, True))
    assert torch.equal(out[0, 0], table[3]) and not out[0, 1].any() and not out[1, 0].any()
    with pytest.raises(ValueError, match=r"\[N, row\]"):
        gather_rows(table[0], torch.tensor([0]))
