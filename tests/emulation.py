"""Build the port's CUDA sources with g++ against `tests/cuda_emulation.h`.

The sources are taken as they are, apart from three textual changes: the
`<<<...>>>` launches become calls of `emu_launch`, the dynamic
shared-memory declarations become pointers to the emulated block's
shared memory, and `csrc/wgmma.cuh` (the PTX of `wgmma` and the other
warpgroup instructions of K2) and `csrc/cpasync.cuh` (the PTX of
`cp.async`, the bulk copy and the mbarriers) are replaced by the
emulation's stand-ins for their functions.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess

from vss_tpu_torch import csrc

TESTS = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.dirname(os.path.abspath(csrc.__file__))

_WGMMA_STUB = """#pragma once
// the emulation's wgmma and warpgroup stand-ins (tests/cuda_emulation.h)
#include "cuda_emulation.h"
namespace vss {
using ::fence_operand;
using ::fence_proxy_async;
using ::min_nan;
using ::setmaxnreg_dec;
using ::setmaxnreg_inc;
using ::warpgroup_sync;
using ::wgmma_commit;
using ::wgmma_fence;
using ::wgmma_m64n64k16;
using ::wgmma_m64n64k16_zero;
using ::wgmma_m64n32k16;
using ::wgmma_m64n32k16_zero;
using ::wgmma_wait;
}  // namespace vss
"""


_CPASYNC_STUB = """#pragma once
// the emulation's cp.async, bulk copy and mbarrier stand-ins
// (tests/cuda_emulation.h)
#include "cuda_emulation.h"
namespace vss {
using ::bulk_copy;
using ::cp_async16;
using ::cp_async_arrive;
using ::cp_async_commit;
using ::cp_async_wait;
using ::mbar_arrive;
using ::mbar_expect_tx;
using ::mbar_init;
using ::mbar_init_fence;
using ::mbar_wait;
using ::smem_addr;
}  // namespace vss
"""

# headers of csrc/ replaced by the emulation's stand-ins for their PTX
_STUBS = {"wgmma.cuh": _WGMMA_STUB, "cpasync.cuh": _CPASYNC_STUB}

# Mutants of csrc/tiles.cuh, the tile code that K2 (scan.cu) and
# pivot_product (pivots.cu) share, as edits of the headers (`setup`): the
# mutant tests of each kernel that includes it take every one. SBO one
# atom row instead of one atom; warp w's rows 16w.. of each m64 tile, as a
# plain m64 product would map them, not its own 32-row sub-segment.
TILE_MUTANTS = {
    "descriptor_stride": [("(static_cast<uint64_t>(ATOM >> 4) << 32)",
                           "(static_cast<uint64_t>(ATOM_ROW >> 4) << 32)")],
    "subsegment_rows": [("const int r = 32 * warp + 16 * mt + 8 * h + g;",
                         "const int r = 16 * warp + 64 * mt + 8 * h + g;")],
}


def for_gpp(text: str) -> str:
    text = text.replace("extern __shared__ __align__(16) unsigned char smem[];",
                        "unsigned char* smem = emu.smem;")
    text = text.replace("extern __shared__ float qs[];",
                        "float* qs = reinterpret_cast<float*>(emu.smem);")

    def launch(m):
        grid, block, smem = (a.strip() for a in m.group(2).replace("\n", " ").split(",")[:3])
        return f"emu_launch({m.group(1)}, {grid}, {block}, {smem}, "

    return re.sub(r"([\w:]+(?:<\w+>)?)<<<(.*?)>>>\(", launch, text, flags=re.S)


def gpp(src, out) -> ctypes.CDLL:
    """Compile one C++ source that includes the emulation into a shared
    library and load it. Each f32 operation rounds on its own."""
    work = os.path.dirname(str(src))
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-I", work,
         "-x", "c++", str(src), "-o", str(out)],
        check=True, capture_output=True, text=True, timeout=600)
    return ctypes.CDLL(str(out))


def setup(work, edits=()) -> None:
    """Fill the directory `work` with the emulation header, stand-ins for
    the CUDA headers, and the port's headers as g++ takes them. `edits`,
    pairs (old, new), are applied to the port's headers, each of them
    required to match one (a mutant of a shared header)."""
    for header in ("cuda_bf16.h", "cuda_runtime.h", "math_constants.h"):
        (work / header).write_text('#include "cuda_emulation.h"\n')
    shutil.copy(os.path.join(TESTS, "cuda_emulation.h"), work / "cuda_emulation.h")
    texts = {}
    for name in csrc._HEADERS:
        with open(os.path.join(CSRC, name)) as f:
            texts[name] = _STUBS.get(name) or for_gpp(f.read())
    for old, new in edits:
        hits = [name for name, text in texts.items() if old in text]
        if not hits:
            raise ValueError(f"no header of csrc/ has {old!r}")
        for name in hits:
            texts[name] = texts[name].replace(old, new)
    for name, text in texts.items():
        (work / name).write_text(text)


def build(work, libraries, edits=()) -> dict[str, ctypes.CDLL]:
    """lib<name>.so for each name, from csrc/<name>.cu, in `work` (after
    `setup`). Each library also exports `emu_divergence_count`. `edits`,
    pairs (old, new), are applied to each source first, each of them
    required to match (a mutant of a kernel; build it in a directory of
    its own, since a library path is loaded only once)."""
    libs = {}
    for name in libraries:
        with open(os.path.join(CSRC, f"{name}.cu")) as f:
            text = f.read()
        for old, new in edits:
            if old not in text:
                raise ValueError(f"{name}.cu has no {old!r}")
            text = text.replace(old, new)
        text = for_gpp(text)
        text += '\nextern "C" int emu_divergence_count() { return emu_divergences; }\n'
        (work / f"{name}.cu").write_text(text)
        libs[name] = gpp(work / f"{name}.cu", work / f"lib{name}.so")
    return libs


def entry(lib, kernel):
    """The C entry point of `kernel` (a `csrc.Kernel`) in an emulated
    library, with its argument types and the stream last."""
    fn = getattr(lib, kernel.symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = kernel.argtypes + [csrc.PTR]
    return fn
