"""K2 (`csrc/scan.cu`, `native_segmin`) compiled with g++ and run on the
CPU, against its plain version `_native_segmin_plain`.

K2 computes its products with the tensor cores' `mma.sync` fed by
`ldmatrix` (`csrc/mma.cuh`). Here `tests/cuda_emulation.h` stands in for
those two instructions, written from the PTX ISA's fragment tables, and
the first tests hold the stand-ins alone against numpy with the tables
written out once more below, so that an error in the kernel's use of the
fragments cannot repeat itself in its test.

The data are integer-valued (f32 tapes: values that round to bf16 on
multiples of 2^-6, under 2^17 in magnitude), so every f32 sum is exact in
any order and the kernel must equal the plain version exactly for l2sq
and ip; cosine multiplies by `rsqrtf`, which the emulation computes as
1/sqrtf: within 1e-6 relative. The emulation shows what a kernel
computes, never how fast, and it cannot show a missing barrier.
"""
import ctypes
import shutil

import numpy as np
import pytest
import torch

import emulation
from vss_tpu_torch.ops import scan as tscan

_HARNESS = r"""
#include "cuda_emulation.h"

__global__ void mma_kernel(const uint32_t* a, const uint32_t* b, float* c) {
  const int l = threadIdx.x;
  uint32_t ra[4], rb[2];
  float rc[4];
  for (int i = 0; i < 4; ++i) ra[i] = a[4 * l + i];
  for (int i = 0; i < 2; ++i) rb[i] = b[2 * l + i];
  for (int i = 0; i < 4; ++i) rc[i] = c[4 * l + i];
  mma_bf16_16816(rc, ra, rb);
  for (int i = 0; i < 4; ++i) c[4 * l + i] = rc[i];
}

__global__ void ldmatrix_kernel(const uint16_t* base, const int* offsets, uint32_t* out) {
  const int l = threadIdx.x;
  uint32_t r[4];
  ldmatrix_x4(r, base + offsets[l]);
  for (int i = 0; i < 4; ++i) out[4 * l + i] = r[i];
}

extern "C" void emu_mma(const uint32_t* a, const uint32_t* b, float* c) {
  emu_launch(mma_kernel, 1, 32, 0, a, b, c);
}
extern "C" void emu_ldmatrix(const uint16_t* base, const int* offsets, uint32_t* out) {
  emu_launch(ldmatrix_kernel, 1, 32, 0, base, offsets, out);
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """libscan built by g++ from scan.cu, and a harness that runs one warp
    of the ldmatrix and mma stand-ins."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    work = tmp_path_factory.mktemp("cuda_emulation")
    emulation.setup(work)
    libs = emulation.build(work, ("scan",))
    (work / "harness.cpp").write_text(_HARNESS)
    libs["harness"] = emulation.gpp(work / "harness.cpp", work / "libharness.so")
    return libs


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _bf16_bits(v: np.ndarray) -> np.ndarray:
    """bf16 bit patterns of values exact in bf16."""
    bits = v.astype(np.float32).view(np.uint32)
    assert not (bits & 0xFFFF).any()
    return (bits >> 16).astype(np.uint32)


# The PTX ISA's fragment tables for mma.m16n8k16 (.bf16 inputs, .f32
# accumulators), lane = 4 g + t; element i of a lane lives in register
# i // 2, in its low half when i is even.
def _a_at(g, t, i):
    return (g if i in (0, 1, 4, 5) else g + 8), 2 * t + (i & 1) + (8 if i >= 4 else 0)


def _b_at(g, t, i):
    return 2 * t + (i & 1) + (8 if i >= 2 else 0), g


def _c_at(g, t, i):
    return g + (8 if i >= 2 else 0), 2 * t + (i & 1)


def _pack(mat, at, n_elems):
    bits = _bf16_bits(mat)
    regs = np.zeros((32, n_elems // 2), np.uint32)
    for lane in range(32):
        for i in range(n_elems):
            regs[lane, i // 2] |= bits[at(lane >> 2, lane & 3, i)] << (16 * (i & 1))
    return regs


def test_emulated_mma_equals_numpy_tile_product(emulated):
    """One m16n8k16 product with an accumulator, fragments packed from the
    PTX tables here, against numpy's 16x16 by 16x8 product."""
    rng = np.random.default_rng(0)
    a = rng.integers(-50, 51, (16, 16)).astype(np.float32)
    b = rng.integers(-50, 51, (16, 8)).astype(np.float32)
    c0 = rng.integers(-1000, 1001, (16, 8)).astype(np.float32)
    ra, rb = _pack(a, _a_at, 8), _pack(b, _b_at, 4)
    rc = np.zeros((32, 4), np.float32)
    for lane in range(32):
        for i in range(4):
            rc[lane, i] = c0[_c_at(lane >> 2, lane & 3, i)]
    emulated["harness"].emu_mma(_ptr(ra), _ptr(rb), _ptr(rc))
    got = np.zeros((16, 8), np.float32)
    for lane in range(32):
        for i in range(4):
            got[_c_at(lane >> 2, lane & 3, i)] = rc[lane, i]
    np.testing.assert_array_equal(got, a @ b + c0)


def test_emulated_ldmatrix_follows_the_ptx_table(emulated):
    """ldmatrix .x4: lanes 8i..8i+7 give the rows of matrix i, each
    anywhere in memory; lane 4 g + t receives row g, elements 2t, 2t+1 of
    matrix i in register i."""
    rng = np.random.default_rng(1)
    base = rng.integers(0, 1 << 16, 4096).astype(np.uint16)
    offsets = (rng.choice(4096 // 8 - 1, 32, replace=False) * 8).astype(np.int32)
    out = np.zeros((32, 4), np.uint32)
    emulated["harness"].emu_ldmatrix(_ptr(base), _ptr(offsets), _ptr(out))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            row = offsets[8 * i + g]
            want = int(base[row + 2 * t]) | int(base[row + 2 * t + 1]) << 16
            assert out[lane, i] == want, (lane, i)


def _inputs(rng, dtype, nx, nq, d, nan_query):
    if dtype == "f32":
        # magnitudes 2..100 with fractions that bf16 must round
        mag = rng.integers(2, 100, (nx, d)) + rng.choice([0.0, 0.3, 0.55, 0.7], (nx, d))
        x = torch.from_numpy((mag * rng.choice([-1.0, 1.0], (nx, d))).astype(np.float32))
    else:
        x = torch.from_numpy(rng.integers(-100, 101, (nx, d)).astype(np.float32))
        x = x.to({"int8": torch.int8, "bf16": torch.bfloat16}[dtype])
    x[11] = 0  # a zero row
    xn = (x.float() ** 2).sum(-1)
    valid = torch.from_numpy(rng.random(nx) > 0.1)
    valid[32:64] = False  # a whole invalid sub-segment
    valid[11] = True
    q = torch.from_numpy(rng.integers(-4, 5, (nq, d)).astype(np.float32))
    if nan_query:
        q[5, 3] = float("nan")
    return q.to(torch.bfloat16), x, xn, valid


@pytest.mark.parametrize("nq,d", [(1, 100), (200, 192)])
@pytest.mark.parametrize("metric", ["l2sq", "ip", "cosine"])
@pytest.mark.parametrize("dtype", ["int8", "bf16", "f32"])
def test_emulated_k2_equals_plain(emulated, monkeypatch, dtype, metric, nq, d):
    """d=100 is padded to 112 (one step of 64 columns, one of 48); d=192 is
    three steps of 64. nx=333 leaves the last 128-row tile ragged."""
    rng = np.random.default_rng(nq * 1000 + d)
    q, x, xn, valid = _inputs(rng, dtype, 333, nq, d, nan_query=nq > 5)
    want = tscan._native_segmin_plain(q, x, xn, valid, tscan.Metric.parse(metric))
    fn = emulation.entry(emulated["scan"], tscan._K2)
    launched = []

    def launch(operands, *args):
        assert fn(*args, None) == 0
        launched.append(args)

    monkeypatch.setattr(tscan._K2, "launch", launch)
    got = tscan._native_segmin_launch(q, x, xn, valid, tscan.Metric.parse(metric))
    assert len(launched) == 1 and emulated["scan"].emu_divergence_count() == 0
    assert got.shape == want.shape == (12, nq)
    if metric == "cosine":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), want.numpy())  # NaN equals NaN here
    assert np.isinf(got.numpy()[1]).all()  # rows 32..63: the invalid sub-segment
    if nq > 5:
        assert np.isnan(got.numpy()[[0, 2, 3, 4], 5]).all()  # the NaN query
