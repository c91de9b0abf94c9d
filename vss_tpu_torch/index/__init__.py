"""HNSW index core: graph arrays, batched search, construction, CRUD.

Reproduces `vss_tpu/index/__init__.py` for the ported modules.
"""
from vss_tpu_torch.index.dense import HNSWIndex, rescale_distances
from vss_tpu_torch.index.graph import (
    HNSWConfig,
    HNSWGraph,
    empty_graph,
    grow_graph,
    sample_levels,
)
from vss_tpu_torch.index.search import greedy_descent, hnsw_search

__all__ = [
    "HNSWConfig",
    "HNSWGraph",
    "HNSWIndex",
    "empty_graph",
    "grow_graph",
    "sample_levels",
    "greedy_descent",
    "hnsw_search",
    "rescale_distances",
]
