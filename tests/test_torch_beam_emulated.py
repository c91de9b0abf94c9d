"""The CUDA sources of the gather kernels and of `beam_search`, compiled
with g++ and run on the CPU, against their plain versions.

There is no nvcc and no card where these tests run, so the kernels
themselves are held against their plain versions only on the card
(`chip_smoke.py`). What can run here is their C++: `tests/cuda_emulation.h`
stands in for the CUDA headers and runs a block's threads as cooperative
fibers that switch at every barrier and warp exchange. The sources are
taken as they are, apart from two textual changes made below: the
`<<<...>>>` launches become calls and the dynamic shared-memory
declarations become pointers.

The emulation shows what a kernel computes (index arithmetic, the merge
network, tie and NaN rules, the shared-memory layout), never how fast, and
it cannot show a missing barrier. Inputs are integer-valued, so every f32
sum is exact in any order and the kernel must equal the plain loop exactly,
as it must on the card against the loop through K1 and K5.
"""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import vss_tpu_torch.index.search as tsearch
from vss_tpu_torch import HNSWConfig, HNSWIndex, csrc
from vss_tpu_torch.ops import gather as tgather

TESTS = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.dirname(os.path.abspath(csrc.__file__))


def _for_gpp(text: str) -> str:
    text = text.replace("extern __shared__ __align__(16) unsigned char smem[];",
                        "unsigned char* smem = emu.smem;")
    text = text.replace("extern __shared__ float qs[];",
                        "float* qs = reinterpret_cast<float*>(emu.smem);")

    def launch(m):
        grid, block, smem = (a.strip() for a in m.group(2).replace("\n", " ").split(",")[:3])
        return f"emu_launch({m.group(1)}, {grid}, {block}, {smem}, "

    return re.sub(r"([\w:]+(?:<\w+>)?)<<<(.*?)>>>\(", launch, text, flags=re.S)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """libgather and libbeam built by g++ from the .cu sources."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    work = tmp_path_factory.mktemp("cuda_emulation")
    for header in ("cuda_bf16.h", "cuda_runtime.h", "math_constants.h"):
        (work / header).write_text('#include "cuda_emulation.h"\n')
    shutil.copy(os.path.join(TESTS, "cuda_emulation.h"), work / "cuda_emulation.h")
    libs = {}
    for name in ("common.cuh", "gather.cuh", "gather.cu", "beam.cu"):
        with open(os.path.join(CSRC, name)) as f:
            text = _for_gpp(f.read())
        if name.endswith(".cu"):
            text += '\nextern "C" int emu_divergence_count() { return emu_divergences; }\n'
        (work / name).write_text(text)
    for name in ("gather", "beam"):
        out = work / f"lib{name}.so"
        subprocess.run(
            ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-I", str(work),
             "-x", "c++", str(work / f"{name}.cu"), "-o", str(out)],
            check=True, capture_output=True, text=True, timeout=600)
        libs[name] = ctypes.CDLL(str(out))
    return libs


def _entry(lib, kernel):
    fn = getattr(lib, kernel.symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = kernel.argtypes + [csrc.PTR]
    return fn


@pytest.fixture(scope="module")
def world():
    """A small index over integer-valued vectors and its beam inputs."""
    rng = np.random.default_rng(3)
    n, d = 900, 24
    vecs = rng.integers(-6, 7, (n, d)).astype(np.float32)
    idx = HNSWIndex.build(vecs, HNSWConfig(dims=d, m=6), method="native", device="cpu")
    g = idx.graph
    q = torch.from_numpy(rng.integers(-6, 7, (6, d)).astype(np.float32))
    q[4, 2] = float("nan")
    allow = g.valid & torch.from_numpy(rng.random(g.capacity) > 0.2)
    seeds0 = torch.from_numpy(rng.integers(0, n, (6, 3)).astype(np.int32))
    seeds0[1] = -1
    seeds0[2, 1:] = -1
    upper = torch.nonzero(g.levels >= 1)[:, 0].to(torch.int32)
    seeds1 = upper[torch.from_numpy(rng.integers(0, upper.numel(), 6))]
    return idx, q, allow, seeds0, seeds1


def _tape(g, storage):
    if storage == "f32":
        return g.vectors
    return g.vectors.to({"int8": torch.int8, "bf16": torch.bfloat16}[storage])


CASES = [
    # storage, metric, dual, hist, E, level, ef
    ("f32", "l2sq", False, True, 1, 0, 16),
    ("f32", "l2sq", True, True, 1, 0, 16),
    ("f32", "l2sq", True, False, 2, 0, 24),
    ("f32", "l2sq", False, True, 4, 0, 40),
    ("f32", "l2sq", True, True, 4, 1, 8),
    ("f32", "l2sq", False, False, 1, 1, 16),
    ("int8", "l2sq", True, True, 2, 0, 16),
    ("int8", "ip", False, True, 1, 0, 64),
    ("bf16", "l2sq", True, True, 1, 0, 100),
    ("bf16", "ip", True, False, 4, 1, 16),
]


@pytest.mark.parametrize("storage,metric,dual,hist,E,level,ef", CASES)
def test_emulated_beam_kernel_equals_plain_loop(emulated, world, monkeypatch, storage, metric,
                                                dual, hist, E, level, ef):
    idx, q, allow, seeds0, seeds1 = world
    cfg = HNSWConfig(dims=idx.config.dims, m=idx.config.m, metric=metric, storage_dtype=storage)
    g = idx.graph.clone()
    g.vectors = _tape(g, storage)
    seeds = seeds0 if level == 0 else seeds1
    qn = (q * q).sum(-1)
    seed_d = tgather.gather_distances(
        g.vectors, seeds if seeds.dim() == 2 else seeds[:, None], q, metric, qn
    ).reshape(seeds.shape)
    mi = 4 + (2 * ef) // E
    want = tsearch._beam_search_base_plain(g, cfg, q, seeds, seed_d, ef, allow, E, mi, level,
                                           qn, dual, hist)
    fn = _entry(emulated["beam"], tsearch._BEAM)
    launched = []

    def launch(operands, *args):
        assert fn(*args, None) == 0
        launched.append(args)

    monkeypatch.setattr(tsearch._BEAM, "launch", launch)
    pools = tsearch._seed_pools(q, seeds, seed_d, ef, allow)
    res_d, res_i, cand_i, counters = tsearch._beam_launch(
        g, cfg, q, qn, pools, ef, allow, E, mi, level, dual, hist)
    assert len(launched) == 1 and emulated["beam"].emu_divergence_count() == 0
    np.testing.assert_array_equal(res_d.numpy(), want[0].numpy())  # NaN equals NaN here
    np.testing.assert_array_equal(res_i.numpy(), want[1].numpy())
    np.testing.assert_array_equal(cand_i.numpy(), want[2].numpy())
    assert (int(counters[0]), int(counters[1])) == (int(want[3][0]), int(want[3][1]))


def test_emulated_beam_refuses_another_shared_memory_count(emulated, world, monkeypatch):
    """The entry point launches only when the wrapper's count of a block's
    shared memory equals the layout's own."""
    idx, q, allow, seeds0, _ = world
    g, cfg = idx.graph, idx.config
    qn = (q * q).sum(-1)
    seed_d = tgather.gather_distances(g.vectors, seeds0, q, cfg.metric, qn)
    fn = _entry(emulated["beam"], tsearch._BEAM)
    codes = []
    monkeypatch.setattr(tsearch._BEAM, "launch", lambda operands, *args: codes.append(fn(*args, None)))
    right = tsearch.beam_smem_bytes
    for off in (0, 16):
        monkeypatch.setattr(tsearch, "beam_smem_bytes", lambda *a: right(*a) + off)
        tsearch._beam_launch(g, cfg, q, qn, tsearch._seed_pools(q, seeds0, seed_d, 16, allow),
                             16, allow, 1, 36, 0, True, True)
    assert codes[0] == 0 and codes[1] != 0


@pytest.mark.parametrize("storage,d", [("f32", 24), ("int8", 48), ("bf16", 16), ("f32", 19)])
@pytest.mark.parametrize("metric", ["l2sq", "ip"])
def test_emulated_k1_equals_plain(emulated, storage, d, metric):
    rng = np.random.default_rng(d)
    table = torch.from_numpy(rng.integers(-6, 7, (300, d)).astype(np.float32))
    table = table.to({"f32": torch.float32, "int8": torch.int8, "bf16": torch.bfloat16}[storage])
    q = torch.from_numpy(rng.integers(-6, 7, (5, d)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-1, 300, (5, 21)).astype(np.int32))
    qn = (q * q).sum(-1)
    want = tgather._gather_distances_plain(table, ids, q, tgather.Metric.parse(metric), qn)
    out = torch.empty((5, 21), dtype=torch.float32)
    fn = _entry(emulated["gather"], tgather._K1)
    assert fn(ids.data_ptr(), q.data_ptr(), qn.data_ptr(), table.data_ptr(), out.data_ptr(),
              5, 21, d, csrc.dtype_code(table.dtype), tgather.METRIC_IDS[
                  tgather.Metric.parse(metric)], None) == 0
    assert emulated["gather"].emu_divergence_count() == 0
    np.testing.assert_array_equal(out.numpy(), want.numpy())


@pytest.mark.parametrize("dtype,row,skip_neg", [
    (torch.int32, 32, False), (torch.int8, 100, True), (torch.float32, 33, False),
    (torch.int8, 99, True)])
def test_emulated_k5_equals_plain(emulated, dtype, row, skip_neg):
    rng = np.random.default_rng(row)
    table = torch.from_numpy(rng.integers(-100, 100, (200, row))).to(dtype)
    ids = torch.from_numpy(rng.integers(-2, 200, (37,)).astype(np.int32))
    want = tgather._gather_rows_plain(table, ids, skip_neg)
    out = torch.empty((37, row), dtype=dtype)
    fn = _entry(emulated["gather"], tgather._K5)
    assert fn(ids.data_ptr(), table.data_ptr(), out.data_ptr(), 37, row * table.element_size(),
              int(skip_neg), None) == 0
    np.testing.assert_array_equal(out.numpy(), want.numpy())
