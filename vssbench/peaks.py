"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at
its 700 W limit), and the operations and bytes of the kernels whose
rooflines the benchmark reports, counted from the shapes."""
from __future__ import annotations

H100 = {
    "bf16_flops": 989e12,
    "f32_flops": 67e12,
    "hbm_bytes": 3.35e12,
}

_ITEM = {"int8": 1, "bf16": 2, "f32": 4}


def scan_pass_bound_s(nq: int, n: int, d: int, storage: str, peaks=H100) -> float:
    """The least time of the exact scan's phase A: every query against
    every stored row, its products in bf16 (int8 and bf16 tapes widen to
    bf16; an f32 tape takes the f32 rate). Bytes: the tape, the queries
    (float32) and one float32 minimum per query and 32-row sub-segment,
    each once."""
    flops = 2.0 * nq * n * d
    rate = peaks["f32_flops"] if storage == "f32" else peaks["bf16_flops"]
    nbytes = n * d * _ITEM[storage] + nq * d * 4 + nq * -(-n // 32) * 4
    return max(flops / rate, nbytes / peaks["hbm_bytes"])
