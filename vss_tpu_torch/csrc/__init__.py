"""Native components: build at first use, load with ctypes, count launches.

Reproduces `vss_tpu/csrc/__init__.py`. The host-side HNSW builder and
the linked-block store (`hnsw_builder.cpp`, `blockstore.cpp`, copied
from the JAX package) are compiled with g++; each CUDA
source (`*.cu`) is compiled by `nvcc` for `sm_90a` into a shared library
with a plain C interface. Everything lands in `vss_tpu_torch/_build/`,
never next to the sources, and is rebuilt only when a source is newer
than its library.

Every CUDA entry point returns `cudaGetLastError()` after its launch;
`Kernel.launch` raises on a nonzero code and counts successful launches
in `Kernel.launches`, a plain integer, under a lock of its own so that
queries run from several threads count every launch.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")

# library name -> source file under csrc/
SOURCES = {
    "hnsw_builder": "hnsw_builder.cpp",
    "blockstore": "blockstore.cpp",
    "gather": "gather.cu",
    "scan": "scan.cu",
    "topk": "topk.cu",
    "distance": "distance.cu",
    "beam": "beam.cu",
    "descent": "descent.cu",
    # a latency measurement, not a kernel of any path (see probe.cu)
    "probe": "probe.cu",
}
_HEADERS = ("common.cuh", "gather.cuh", "mma.cuh")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


class NativeUnavailable(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise NativeUnavailable("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    so = _lib_path(name)
    if not os.path.exists(so):
        return True
    deps = [SOURCES[name]]
    if SOURCES[name].endswith(".cu"):
        deps += list(_HEADERS)
    built = os.path.getmtime(so)
    return any(os.path.getmtime(os.path.join(_DIR, f)) > built for f in deps)


def _command(name: str, out: str) -> list[str]:
    src = os.path.join(_DIR, SOURCES[name])
    if src.endswith(".cpp"):
        return [
            "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            "-pthread", "-o", out, src,
        ]
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-I", _DIR, "-o", out, src,
    ]


def build(names=None) -> float:
    """Compile every stale library in `names` (default: all), one
    compiler process per source, all started together. Returns the
    seconds taken. Each library is written under a temporary name and
    renamed into place, so concurrent builders never load a partial
    file. The compiler's output (ptxas register and spill counts for
    the kernels) is kept in `_build/<name>.log`."""
    names = list(SOURCES) if names is None else list(names)
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    try:
        for name in names:
            if not _stale(name):
                continue
            tmp = f"{_lib_path(name)}.{os.getpid()}.{threading.get_ident()}.tmp"
            try:
                proc = subprocess.Popen(
                    _command(name, tmp), stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True,
                )
            except OSError as e:
                raise NativeUnavailable(f"cannot run the compiler for {name}: {e}") from e
            procs.append((name, tmp, proc))
        failed = []
        for name, tmp, proc in procs:
            log, _ = proc.communicate(timeout=600)
            with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
                f.write(log)
            if proc.returncode != 0:
                failed.append(f"{name}: {log[-2000:]}")
                continue
            os.replace(tmp, _lib_path(name))
        if failed:
            raise NativeUnavailable("build failed:\n" + "\n".join(failed))
    finally:
        for name, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """Load lib<name>.so from the build directory, building it first if
    it is missing or stale."""
    with _LOCK:
        if name not in _LIBS:
            build([name])
            _LIBS[name] = ctypes.CDLL(_lib_path(name))
        return _LIBS[name]


# ctypes argument kinds for Kernel signatures
PTR = ctypes.c_void_p
I32 = ctypes.c_int32
I64 = ctypes.c_int64


def _current_stream(index: int) -> int:
    """The handle of PyTorch's current stream on CUDA device `index`, from
    PyTorch's own getter of it: it spares the `torch.cuda.Stream` object
    that `torch.cuda.current_stream` builds on every call."""
    return torch._C._cuda_getCurrentRawStream(index)


class Kernel:
    """One hand-written CUDA kernel behind a C entry point `symbol` in
    lib<library>.so. The entry point takes the given arguments plus the
    CUDA stream last, launches, and returns cudaGetLastError()."""

    def __init__(self, name: str, library: str, symbol: str, argtypes: list):
        self.name = name
        self.library = library
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._count_lock = threading.Lock()
        self._fn = None

    def _entry(self):
        if self._fn is None:
            lib = load(self.library)
            fn = getattr(lib, self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes + [PTR]
            err = lib.vss_cuda_error_string
            err.restype = ctypes.c_char_p
            err.argtypes = [ctypes.c_int]
            self._err = err
            self._fn = fn
        return self._fn

    def launch(self, operands, *args) -> None:
        """Launch on the current stream of the one CUDA device that holds
        every tensor in `operands`; raise on a launch error."""
        device = operands[0].device
        for t in operands:
            if t.device != device:
                device = None
                break
        if device is None or device.type != "cuda":
            raise ValueError(f"{self.name}: kernel needs its tensors on one CUDA device, "
                             f"got {sorted(str(t.device) for t in operands)}")
        index = torch.cuda.current_device()
        if device.index is not None and device.index != index:
            raise ValueError(
                f"{self.name}: tensors on cuda:{device.index} but the current device "
                f"is cuda:{index}"
            )
        fn = self._fn or self._entry()
        rc = fn(*args, _current_stream(index))
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed ({rc}: "
                f"{self._err(rc).decode()})"
            )
        with self._count_lock:
            self.launches += 1


def operand(t):
    """`t` as a kernel operand: contiguous and 16-byte aligned (a view at
    an odd storage offset is copied), so the kernels' 16-byte loads are
    legal."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def dtype_code(dtype) -> int:
    """The kernels' element-type code (common.cuh `DType`)."""
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
    if dtype not in codes:
        raise ValueError(f"unsupported tape dtype {dtype}")
    return codes[dtype]


# every kernel of the port, by name (filled by the ops modules)
KERNELS: dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
