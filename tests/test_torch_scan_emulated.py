"""K2 (`csrc/scan.cu`, `native_segmin`) compiled with g++ and run on the
CPU, against its plain version `_native_segmin_plain`.

K2 computes its products with Hopper's `wgmma` (A, the decoded tape rows,
from registers; B, the resident queries, from shared memory by
descriptor: `csrc/wgmma.cuh`) and streams the tape through a ring of
stages filled by bulk copies that complete on mbarriers
(`csrc/cpasync.cuh`). Here `tests/cuda_emulation.h` stands in for those
instructions, written from the PTX ISA's tables, and the first tests hold
the `wgmma` stand-in alone against numpy, with the fragment tables and
the descriptor's canonical layouts written out once more below, so that
an error in the kernel's use of the fragments cannot repeat itself in its
test.

The data are integer-valued (f32 tapes: values that round to bf16 on
multiples of 2^-6, under 2^17 in magnitude), so every f32 sum is exact in
any order and the kernel must equal the plain version exactly for l2sq
and ip; cosine multiplies by `rsqrtf`, which the emulation computes as
1/sqrtf: within 1e-6 relative. Four mutants (a wrong descriptor stride
and a sub-segment mapped to the wrong rows, both in the tile code that
`csrc/tiles.cuh` shares with pivot_product; a ring stage read before its
wait, the consumers' ring stages shared) must each fail a case. The emulation shows what
a kernel computes, never how fast, and it cannot show a missing barrier.
One test, marked `cuda`, holds the kernel itself against the plain
version where a CUDA device is present and skips elsewhere; on the card
(no JAX there, so without this directory's conftest): `python -m pytest
--noconftest -o addopts="" -m cuda tests/test_torch_scan_emulated.py -q`.
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

// one warpgroup: B's image copied into shared memory, then two groups of
// one product each on copies of the accumulators, the first without them
// (the form that writes) unless scale_d, the second with them; `mid`
// receives the accumulators after wait<1> (only the first group landed),
// `d` after wait<0>
__global__ void wgmma_kernel(const uint32_t* a, const unsigned char* img, int img_bytes,
                             uint64_t desc, float* d, float* mid, int scale_d) {
  const int l = threadIdx.x;
  if (l == 0) memcpy(emu.smem, img, img_bytes);
  __syncthreads();
  uint32_t ra[4];
  float first[32], second[32];
  for (int i = 0; i < 4; ++i) ra[i] = a[4 * l + i];
  for (int i = 0; i < 32; ++i) first[i] = second[i] = d[32 * l + i];
  wgmma_fence();
  if (scale_d)
    wgmma_m64n64k16(first, ra, desc);
  else
    wgmma_m64n64k16_zero(first, ra, desc);
  wgmma_commit();
  wgmma_m64n64k16(second, ra, desc);
  wgmma_commit();
  wgmma_wait<1>();
  for (int i = 0; i < 32; ++i) mid[64 * l + i] = first[i];
  for (int i = 0; i < 32; ++i) mid[64 * l + 32 + i] = second[i];
  wgmma_wait<0>();
  for (int i = 0; i < 32; ++i) d[32 * l + i] = first[i];
  for (int i = 0; i < 32; ++i) d[32 * 128 + 32 * l + i] = second[i];
}

extern "C" void emu_wgmma(const uint32_t* a, const unsigned char* img, int img_bytes,
                         uint64_t desc, float* d, float* mid, int scale_d) {
  emu_launch(wgmma_kernel, 1, 128, img_bytes, a, img, img_bytes, desc, d, mid, scale_d);
}
"""

# the mutants of scan.cu: the stage decoded before its mbarrier is
# awaited; the two consumers' stages shared (a consumer's wait can pass on
# the other's phase). With them, those of the tile code it shares with
# pivot_product (`emulation.TILE_MUTANTS`, edits of csrc/tiles.cuh).
_MUTANTS = {
    "stage_before_wait": [(
        "      mbar_wait(&full[st], pos.parity);\n"
        "      with_steps(w / 16, [&](auto steps) {\n"
        "        decode_slab<TX, decltype(steps)::value>(a, ring + st * p.stage_bytes, warp, g, t);\n"
        "      });\n",
        "      with_steps(w / 16, [&](auto steps) {\n"
        "        decode_slab<TX, decltype(steps)::value>(a, ring + st * p.stage_bytes, warp, g, t);\n"
        "      });\n"
        "      mbar_wait(&full[st], pos.parity);\n")],
    "shared_stages": [("  return c * p.nsw + st;", "  return st;")],
}


def _gpp_or_skip():
    if shutil.which("g++") is None:
        pytest.skip("needs g++")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """libscan built by g++ from scan.cu, and a harness that runs one
    warpgroup of the wgmma stand-in."""
    _gpp_or_skip()
    work = tmp_path_factory.mktemp("cuda_emulation")
    emulation.setup(work)
    libs = emulation.build(work, ("scan",))
    (work / "harness.cpp").write_text(_HARNESS)
    libs["harness"] = emulation.gpp(work / "harness.cpp", work / "libharness.so")
    return libs


@pytest.fixture(scope="module", params=sorted(_MUTANTS) + sorted(emulation.TILE_MUTANTS))
def mutant(request, tmp_path_factory):
    _gpp_or_skip()
    work = tmp_path_factory.mktemp("cuda_emulation")
    emulation.setup(work, emulation.TILE_MUTANTS.get(request.param, ()))
    return request.param, emulation.build(work, ("scan",), _MUTANTS.get(request.param, ()))["scan"]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _bf16_bits(v: np.ndarray) -> np.ndarray:
    """bf16 bit patterns of values exact in bf16."""
    bits = v.astype(np.float32).view(np.uint32)
    assert not (bits & 0xFFFF).any()
    return (bits >> 16).astype(np.uint32)


def _bf16_values(rng, shape) -> np.ndarray:
    """Random real values rounded to bf16 (by truncation of f32)."""
    v = (rng.standard_normal(shape) * 4).astype(np.float32)
    return (v.view(np.uint32) & 0xFFFF0000).view(np.float32)


# The PTX ISA's register fragments of wgmma .m64nNk16 (.bf16 inputs, .f32
# accumulators) for thread `th` of the warpgroup: warp w = th // 32 holds
# rows 16w..16w+15; lane = 4 g + t.
def _a_at(th, i):
    """Row and k of A element i (register i // 2, half i % 2)."""
    w, g, t = th // 32, (th % 32) // 4, th % 4
    reg = i // 2
    return 16 * w + g + 8 * (reg % 2), 2 * t + (i % 2) + 8 * (reg // 2)


def _d_at(th, r):
    """Row and n of D register r (n8 block r // 4)."""
    w, g, t = th // 32, (th % 32) // 4, th % 4
    j, i = r // 4, r % 4
    return 16 * w + g + 8 * (i // 2), 8 * j + 2 * t + (i % 2)


# The descriptor (PTX ISA, "Matrix Descriptor Format") and the canonical
# K-major layouts of B (16 k x 64 n, each n's k values consecutive).
def _desc(start, lbo, sbo, mode):
    return (start >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32) | (mode << 62)


def _image(b, start, lbo, sbo, mode, size):
    """B's bytes in shared memory: no swizzle (mode 0): 8 x 8 core
    matrices, 8 rows (n) of 16 bytes (8 k), matrix (n // 8, k // 8) at
    start + (n // 8) SBO + (k // 8) LBO; 128-byte swizzle (mode 1): row n
    of 128 bytes at start + (n // 8) SBO + (n % 8) 128, value k at byte
    2k of it, and the 16-byte chunk number of every address XORed with
    address bits 7-9."""
    img = np.full(size, 0xAB, np.uint8)
    bits = _bf16_bits(b)
    for k in range(16):
        for n in range(64):
            if mode == 0:
                addr = start + (n // 8) * sbo + (k // 8) * lbo + (n % 8) * 16 + (k % 8) * 2
            else:
                addr = start + (n // 8) * sbo + (n % 8) * 128 + 2 * k
                addr ^= ((addr >> 7) & 7) << 4
            img[addr:addr + 2] = np.frombuffer(np.uint16(bits[k, n]).tobytes(), np.uint8)
    return img


# (start, LBO, SBO, mode): the kernel's layout (k halves next to each
# other, 8-query groups 256 bytes apart), the k halves far apart and the
# groups packed, a start past zero, and 128-byte swizzle at two offsets of
# a k16 step within its 128-byte row
_LAYOUTS = [(0, 128, 256, 0), (0, 1024, 128, 0), (2048 + 16 * 5, 256, 512, 0),
            (0, 0, 1024, 1), (1024 + 32, 0, 1024, 1)]


@pytest.mark.parametrize("start,lbo,sbo,mode", _LAYOUTS)
def test_emulated_wgmma_equals_numpy_product(emulated, start, lbo, sbo, mode):
    """Two m64n64k16 products on the same A and B, fragments packed from
    the PTX tables here and B laid out by descriptor, against numpy's
    64x16 by 16x64 product: the first group without the accumulator
    (scale_d 0, or with it), the second with it; after wait<1> only the
    first group has landed, after wait<0> both."""
    rng = np.random.default_rng(start + lbo + sbo + mode)
    a = _bf16_values(rng, (64, 16))
    b = _bf16_values(rng, (16, 64))
    c0 = (rng.standard_normal((64, 64)) * 10).astype(np.float32)
    abits = _bf16_bits(a)
    ra = np.zeros((128, 4), np.uint32)
    rd = np.zeros((128, 32), np.float32)
    for th in range(128):
        for i in range(8):
            ra[th, i // 2] |= abits[_a_at(th, i)] << (16 * (i % 2))
        for r in range(32):
            rd[th, r] = c0[_d_at(th, r)]
    size = start + 8 * max(sbo, 128) + 2 * max(lbo, 128) + 1024
    img = _image(b, start, lbo, sbo, mode, size)
    out = np.concatenate([rd, rd])
    mid = np.zeros((128, 64), np.float32)
    for scale_d in (0, 1):
        out[:] = np.concatenate([rd, rd])
        emulated["harness"].emu_wgmma(_ptr(ra), _ptr(img), size,
                                      ctypes.c_uint64(_desc(start, lbo, sbo, mode)), _ptr(out),
                                      _ptr(mid), scale_d)
        prod = a.astype(np.float64) @ b.astype(np.float64)
        want_first = (prod + (c0 if scale_d else 0)).astype(np.float32)
        want_second = (prod + c0).astype(np.float32)
        got_first, got_second = np.zeros((64, 64), np.float32), np.zeros((64, 64), np.float32)
        mid_first, mid_second = np.zeros((64, 64), np.float32), np.zeros((64, 64), np.float32)
        for th in range(128):
            for r in range(32):
                got_first[_d_at(th, r)] = out[th, r]
                got_second[_d_at(th, r)] = out[128 + th, r]
                mid_first[_d_at(th, r)] = mid[th, r]
                mid_second[_d_at(th, r)] = mid[th, 32 + r]
        np.testing.assert_allclose(got_first, want_first, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(got_second, want_second, rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(mid_first, got_first)
        np.testing.assert_array_equal(mid_second, c0)  # the second group not landed


def test_emulated_wgmma_descriptor_fields(emulated):
    """The descriptor's fields sit where the PTX table puts them: a B that
    is one value at one (n, k), read through descriptors whose every
    field moves it, lands at that (n, k) of the product only."""
    rng = np.random.default_rng(5)
    ra = np.zeros((128, 4), np.uint32)
    one = 0x3F80  # bf16 1.0
    for th in range(128):  # A = all ones
        ra[th] = one | (one << 16)
    for (start, lbo, sbo), (n, k) in (((0, 128, 256), (9, 12)), ((4096, 2048, 128), (63, 0)),
                                      ((32, 4096, 256), (5, 9)), ((0, 128, 2048), (33, 15))):
        b = np.zeros((16, 64), np.float32)
        b[k, n] = float(rng.integers(1, 9))
        size = start + 8 * sbo + 2 * lbo + 2048
        img = _image(b, start, lbo, sbo, 0, size)
        img[img == 0xAB] = 0  # no other value anywhere
        out = np.zeros((256, 32), np.float32)
        mid = np.zeros((128, 64), np.float32)
        emulated["harness"].emu_wgmma(_ptr(ra), _ptr(img), size,
                                      ctypes.c_uint64(_desc(start, lbo, sbo, 0)), _ptr(out),
                                      _ptr(mid), 0)
        got = np.zeros((64, 64), np.float32)
        for th in range(128):
            for r in range(32):
                got[_d_at(th, r)] = out[th, r]
        want = np.zeros((64, 64), np.float32)
        want[:, n] = b[k, n]
        np.testing.assert_array_equal(got, want)


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


def _run(lib, monkeypatch, q, x, xn, valid, metric):
    """K2's wrapper with its launch routed to the emulated library: the
    output and the launches made."""
    fn = emulation.entry(lib, tscan._K2)
    launched = []

    def launch(operands, *args):
        assert fn(*args, None) == 0
        launched.append(args)

    monkeypatch.setattr(tscan._K2, "launch", launch)
    got = tscan._native_segmin_launch(q, x, xn, valid, tscan.Metric.parse(metric))
    return got, launched


def _check(got, want, metric):
    if metric == "cosine":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), want.numpy())  # NaN equals NaN here


@pytest.mark.parametrize("nq,d", [(1, 100), (200, 192)])
@pytest.mark.parametrize("metric", ["l2sq", "ip", "cosine"])
@pytest.mark.parametrize("dtype", ["int8", "bf16", "f32"])
def test_emulated_k2_equals_plain(emulated, monkeypatch, dtype, metric, nq, d):
    """d=100 is padded to 112 (one slab of seven k16 steps); d=192 is two
    slabs, of 128 and 64 columns, with 64 queries a tile (four query tiles
    at 200). nx=333 leaves the last 128-row tile ragged."""
    rng = np.random.default_rng(nq * 1000 + d)
    q, x, xn, valid = _inputs(rng, dtype, 333, nq, d, nan_query=nq > 5)
    want = tscan._native_segmin_plain(q, x, xn, valid, tscan.Metric.parse(metric))
    got, launched = _run(emulated["scan"], monkeypatch, q, x, xn, valid, metric)
    assert len(launched) == 1 and emulated["scan"].emu_divergence_count() == 0
    assert got.shape == want.shape == (12, nq)
    _check(got, want, metric)
    assert np.isinf(got.numpy()[1]).all()  # rows 32..63: the invalid sub-segment
    if nq > 5:
        assert np.isnan(got.numpy()[[0, 2, 3, 4], 5]).all()  # the NaN query


# (dtype, nx, nq, d, metric): the f32 tape's ring leaves room for 384
# queries a tile (two query tiles at 400); bf16's for 640 (two at 700);
# one and eight queries in a chunk of 64; three slabs a row with two query
# tiles of 64; f32 rows of 800 values, whose 64 queries do not fit beside
# the ring, so each consumer writes the queries' slab beside each tape
# slab; every case ragged, over 3-16 tiles, each of the 4 emulated SMs'
# blocks taking several where there are more
_SHAPES = [
    ("f32", 1000, 400, 128, "l2sq"),
    ("bf16", 2000, 700, 128, "ip"),
    ("int8", 1300, 1, 128, "cosine"),
    ("int8", 1300, 8, 128, "l2sq"),
    ("int8", 1100, 70, 272, "l2sq"),
    ("f32", 333, 70, 800, "cosine"),
]


@pytest.mark.parametrize("dtype,nx,nq,d,metric", _SHAPES)
def test_emulated_k2_tiles_and_widths(emulated, monkeypatch, dtype, nx, nq, d, metric):
    rng = np.random.default_rng(nx + nq + d)
    q, x, xn, valid = _inputs(rng, dtype, nx, nq, d, nan_query=nq > 5)
    valid[nx - 100:nx - 60] = False  # invalid rows in the last tiles too
    want = tscan._native_segmin_plain(q, x, xn, valid, tscan.Metric.parse(metric))
    got, launched = _run(emulated["scan"], monkeypatch, q, x, xn, valid, metric)
    assert len(launched) == 1 and emulated["scan"].emu_divergence_count() == 0
    _check(got, want, metric)


# each mutant's cases (dtype, nx, nq, d, metric): the queries resident, in
# one slab and in two, and streamed; the shared stages where the two
# consumers' uses of one stage interleave
_BOTH = [("int8", 600, 70, 128, "l2sq"), ("bf16", 400, 9, 192, "ip"),
         ("f32", 333, 9, 800, "l2sq")]
_MUTANT_CASES = {"descriptor_stride": _BOTH, "stage_before_wait": _BOTH,
                 "subsegment_rows": _BOTH,
                 "shared_stages": [("int8", 600, 70, 128, "l2sq")]}


def test_mutants_fail_a_case(mutant, monkeypatch):
    """Each mutant fails each of its cases: it differs from the plain
    version, or the emulation counts a divergence (the shared stages: a
    consumer's successive waits on one mbarrier repeat a parity)."""
    name, lib = mutant
    for dtype, nx, nq, d, metric in _MUTANT_CASES[name]:
        rng = np.random.default_rng(nx)
        q, x, xn, valid = _inputs(rng, dtype, nx, nq, d, nan_query=False)
        want = tscan._native_segmin_plain(q, x, xn, valid, tscan.Metric.parse(metric))
        before = lib.emu_divergence_count()
        got, _ = _run(lib, monkeypatch, q, x, xn, valid, metric)
        assert (not np.array_equal(got.numpy(), want.numpy())
                or lib.emu_divergence_count() > before), (name, dtype, nx, nq, d)


@pytest.mark.cuda
def test_k2_kernel_equals_plain_on_the_card():
    """The kernel built by nvcc from csrc/scan.cu, on the card, against
    `_native_segmin_plain` on the same inputs (integer-valued, so the
    plain version's bf16 product is exact too): every dtype and metric at
    the emulated tests' shapes, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    shapes = [(333, 1, 100), (333, 200, 192)] + [(nx, nq, d) for _, nx, nq, d, _ in _SHAPES]
    for nx, nq, d in shapes:
        for dtype in ("int8", "bf16", "f32"):
            rng = np.random.default_rng(nx + nq + d)
            q, x, xn, valid = _inputs(rng, dtype, nx, nq, d, nan_query=nq > 5)
            q, x, xn, valid = q.to(dev), x.to(dev), xn.to(dev), valid.to(dev)
            for metric in ("l2sq", "ip", "cosine"):
                before = tscan._K2.launches
                got = tscan._native_segmin_launch(q, x, xn, valid, tscan.Metric.parse(metric))
                assert tscan._K2.launches == before + 1
                want = tscan._native_segmin_plain(q, x, xn, valid, tscan.Metric.parse(metric))
                torch.cuda.synchronize()
                _check(got.cpu(), want.cpu(), metric)
