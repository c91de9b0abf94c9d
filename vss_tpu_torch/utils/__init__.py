"""Small shared utilities for vss_tpu_torch.

Reproduces `vss_tpu/utils/__init__.py` (without `on_tpu`/`use_pallas`:
the port chooses by device, see `platform.py`).
"""
from vss_tpu_torch.utils.platform import resolve_device
from vss_tpu_torch.utils.shapes import cdiv, next_pow2, pad_dim, pad_to, round_up

__all__ = ["cdiv", "next_pow2", "round_up", "pad_dim", "pad_to", "resolve_device"]
