"""Entry points of the port: the query path, and a dry run over shard slots.

Reproduces `__graft_entry__.py:16-58` for `vss_tpu_torch`:

entry(device=None) -> (fn, example_args): the engine's hot query path, a
batched HNSW search over a host-built graph (64 queries, d=128, k=10,
ef=64), on the card unless `device="cpu"` is passed.

dryrun_multichip(n_devices, device=None): the sharded wave build over
`make_mesh(n_devices, device)` (a wave into every shard, the "training
step" of a vector-search engine), then the search with its merge of the
per-shard lists and the sharded exact scan, on tiny shapes, each held to
self-queries. The build names `method="wave"`: the JAX function leaves it
to `auto`, which takes the bulk builder at these sizes, though its text
describes the wave build.
"""
from __future__ import annotations

import numpy as np

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    import torch

    from vss_tpu_torch.index import HNSWConfig, hnsw_search
    from vss_tpu_torch.index.host_build import build_host_graph, host_graph_to_device
    from vss_tpu_torch.utils import resolve_device

    device = resolve_device(device)  # raises before the build when there is no card
    d = 128
    cfg = HNSWConfig(dims=d)
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((1024, d)).astype(np.float32)
    # host-side build: no device work during entry() itself
    graph = host_graph_to_device(build_host_graph(vecs, cfg, seed=0), device=device)

    def forward(graph, q):
        return hnsw_search(graph, cfg, q, k=10, ef=64)

    q = torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32)).to(graph.device)
    return forward, (graph, q)


def dryrun_multichip(n_devices: int, device=None) -> None:
    from vss_tpu_torch.index import HNSWConfig
    from vss_tpu_torch.parallel import ShardedHNSWIndex, make_mesh

    d = 8
    cfg = HNSWConfig(dims=d, m=4, ef_construction=16, ef_search=8)
    mesh = make_mesh(n_devices, device=device)
    rng = np.random.default_rng(0)
    n = 16 * n_devices
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    # the sharded build step: wave insertion into every shard, then the
    # search with its merge of the per-shard lists
    idx = ShardedHNSWIndex.build(vecs, cfg, mesh, wave_size=8, method="wave")
    _, rows = idx.search(vecs[:4], k=3, ef=8)
    if tuple(rows.shape) != (4, 3):
        raise RuntimeError(f"search returned shape {tuple(rows.shape)}, expected (4, 3)")
    got = rows[:, 0].tolist()
    if got != [0, 1, 2, 3]:
        raise RuntimeError(f"self-query mismatch: {got}")
    # the sharded exact scan (each shard's tape, then the merge)
    _, srows = idx.scan_search(vecs[:4], k=3)
    sgot = srows[:, 0].tolist()
    if sgot != [0, 1, 2, 3]:
        raise RuntimeError(f"scan self-query mismatch: {sgot}")
