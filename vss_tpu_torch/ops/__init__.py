"""Compute ops: distances, top-k, the storage-native scan, the fused gather.

Reproduces `vss_tpu/ops/__init__.py` for the ported modules.
"""
from vss_tpu_torch.ops.distance import (
    Metric,
    dispatch_pairwise,
    distance_one,
    gathered_distances,
    pairwise,
)
from vss_tpu_torch.ops.gather import gather_distances, gather_rows
from vss_tpu_torch.ops.scan import scan_topk
from vss_tpu_torch.ops.topk import bruteforce_topk, merge_topk

__all__ = [
    "Metric",
    "pairwise",
    "dispatch_pairwise",
    "distance_one",
    "gathered_distances",
    "gather_distances",
    "gather_rows",
    "bruteforce_topk",
    "merge_topk",
    "scan_topk",
]
