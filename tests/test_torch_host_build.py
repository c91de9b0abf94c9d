"""vss_tpu_torch.index.host_build against vss_tpu.index.host_build.

The builder is NumPy on both sides, so the host graphs and the packed
arrays must be equal; `host_graph_to_device` puts them on an explicit
device.
"""
import numpy as np
import pytest
import torch

import vss_tpu.index.host_build as jhost
import vss_tpu_torch.index.host_build as thost
from vss_tpu.index.graph import HNSWConfig as JConfig
from vss_tpu_torch.convert import GRAPH_FIELDS
from vss_tpu_torch.index.graph import HNSWConfig as TConfig
from vss_tpu_torch.index.search import hnsw_search
from vss_tpu_torch.ops import bruteforce_topk

N, D = 250, 12


def _vecs(seed=0):
    return np.random.default_rng(seed).standard_normal((N, D)).astype(np.float32)


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_build_host_graph_equal(metric):
    vecs = _vecs()
    jg = jhost.build_host_graph(vecs, JConfig(dims=D, metric=metric, m=8), seed=2)
    tg = thost.build_host_graph(vecs, TConfig(dims=D, metric=metric, m=8), seed=2)
    assert (tg.entry, tg.max_level, tg.n) == (jg.entry, jg.max_level, jg.n)
    np.testing.assert_array_equal(tg.levels, jg.levels)
    np.testing.assert_array_equal(tg.vectors, jg.vectors)
    assert tg.neighbors == jg.neighbors


@pytest.mark.parametrize("storage,capacity", [("f32", None), ("int8", 300), ("bf16", 256)])
def test_host_graph_to_device_equal(storage, capacity):
    vecs = np.round(_vecs(1) * 20)
    rowids = np.arange(N, dtype=np.int64)[::-1] + 50
    jcfg = JConfig(dims=D, storage_dtype=storage)
    tcfg = TConfig(dims=D, storage_dtype=storage)
    jd = jhost.host_graph_to_device(jhost.build_host_graph(vecs, jcfg), rowids, capacity)
    td = thost.host_graph_to_device(
        thost.build_host_graph(vecs, tcfg), rowids, capacity, device="cpu")
    assert td.device.type == "cpu" and td.capacity == (capacity or N)
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(_bits(getattr(td, f)), _bits(getattr(jd, f)), err_msg=f)


def test_host_graph_given_levels_and_search():
    vecs = _vecs(3)
    cfg = TConfig(dims=D)
    levels = np.zeros(N, np.int32)
    levels[::17] = 1
    levels[5] = 3
    g = thost.build_host_graph(vecs, cfg, levels=levels)
    assert g.entry == 5 and g.max_level == 3
    graph = thost.host_graph_to_device(g, device="cpu")
    q = torch.from_numpy(vecs[:40] + 0.01)
    _, si = hnsw_search(graph, cfg, q, k=1, ef=32)
    _, bi = bruteforce_topk(q, torch.from_numpy(vecs), 1, "l2sq", device="cpu")
    assert (si[:, 0] == bi[:, 0]).float().mean() >= 0.95


def test_host_graph_to_device_needs_a_gpu_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    g = thost.build_host_graph(_vecs()[:10], TConfig(dims=D))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thost.host_graph_to_device(g)
