"""Device selection.

Reproduces the role of `vss_tpu/utils/platform.py:14-31`. The JAX
package chose between Pallas kernels and XLA fallbacks by backend (and an
environment override); the port has no switch. Its entry points run on
the CUDA device unless the caller passes `device="cpu"`, and a kernel
wrapper picks its plain PyTorch version only for tensors on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, `cuda` when None. Raises RuntimeError
    when a CUDA device is asked for and none is available: the port never
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev
