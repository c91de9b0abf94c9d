"""bf16 and int8 vector-tape storage of the port: recall against the exact
oracle, as `tests/test_bf16.py` holds `vss_tpu` to.

Sizes are half the reference file's (the wave builder runs eagerly on the
CPU here). The reference's cases that go through `Database` (the SQL
`storage` option, its bad value, the checkpoint) and through
`save_index` / `load_index` wait for the query and storage layers.
"""
import numpy as np
import pytest
import torch

from vss_tpu_torch import HNSWConfig, HNSWIndex
from vss_tpu_torch.index.build import build_graph_batched
from vss_tpu_torch.index.search import hnsw_search
from vss_tpu_torch.ops import bruteforce_topk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several workers share the machine: one intra-op thread each is the
    faster setting for the small eager ops of an insert wave."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def recall(ids, true_ids):
    hits = sum(len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist()))
               for a, b in zip(ids, true_ids))
    return hits / true_ids[true_ids >= 0].size


def test_bf16_build_and_search(rng):
    n, d, k = 1500, 32, 10
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((50, d)).astype(np.float32))
    _, bi = bruteforce_topk(q, torch.from_numpy(vecs), k, "l2sq", device="cpu")
    cfg = HNSWConfig(dims=d, storage_dtype="bf16")
    g, _ = build_graph_batched(vecs, cfg, wave_size=512, device="cpu")
    assert g.vectors.dtype == torch.bfloat16
    _, si = hnsw_search(g, cfg, q, k=k, ef=96)
    r = recall(si.numpy(), bi.numpy())
    assert r >= 0.85, f"bf16 recall {r}"


@pytest.mark.parametrize("expand", [1, 2])
def test_bf16_search_matches_f32_graph_search(rng, expand):
    """The same graph searched over a bf16 and an f32 tape of the same
    (bf16-representable) values gives the same ids."""
    n, d, k = 800, 16, 5
    vecs = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    vecs = vecs.to(torch.bfloat16).float().numpy()
    f32 = HNSWIndex.build(vecs, HNSWConfig(dims=d), method="native", device="cpu")
    q = torch.from_numpy(rng.standard_normal((20, d)).astype(np.float32))
    g16 = f32.graph.clone()
    g16.vectors = g16.vectors.to(torch.bfloat16)
    d32, i32 = hnsw_search(f32.graph, f32.config, q, k=k, ef=32, expand=expand)
    d16, i16 = hnsw_search(g16, HNSWConfig(dims=d, storage_dtype="bf16"), q, k=k, ef=32,
                           expand=expand)
    np.testing.assert_array_equal(i16.numpy(), i32.numpy())
    np.testing.assert_array_equal(d16.numpy(), d32.numpy())


def test_int8_build_and_search(rng):
    n, d, k = 1500, 32, 10
    # byte-ranged data (the int8 sweet spot, like SIFT descriptors)
    vecs = rng.uniform(0, 255, (n, d)).astype(np.float32)
    cfg = HNSWConfig(dims=d, storage_dtype="int8")
    idx = HNSWIndex.build(vecs, cfg, wave_size=512, method="wave", device="cpu")
    assert idx.graph.vectors.dtype == torch.int8
    assert idx.vector_scale > 0
    q = rng.uniform(0, 255, (50, d)).astype(np.float32)
    sd, si = idx.search(q, k=k, ef=96)
    _, bi = bruteforce_topk(torch.from_numpy(q), torch.from_numpy(vecs), k, "l2sq",
                            device="cpu")
    r = recall(si.numpy(), bi.numpy())
    assert r >= 0.85, f"int8 recall {r}"
    # rescaled distances approximate true l2sq
    true_d = ((q[0] - vecs[si.numpy()[0, 0]]) ** 2).sum()
    assert abs(float(sd[0, 0]) - true_d) / max(true_d, 1) < 0.05


def test_int8_crud(rng):
    """The write path on an int8 tape: delete, insert, and a clone that
    answers as the index does (the reference's case goes on to a
    checkpoint round trip)."""
    vecs = rng.uniform(0, 255, (400, 16)).astype(np.float32)
    cfg = HNSWConfig(dims=16, storage_dtype="int8")
    idx = HNSWIndex.build(vecs, cfg, wave_size=128, method="wave", device="cpu")
    assert idx.delete([1, 2]) == 2
    new = rng.uniform(0, 255, (2, 16)).astype(np.float32)
    idx.insert(new, [900, 901])
    assert idx.count == 400
    idx2 = idx.clone()
    assert idx2.vector_scale == idx.vector_scale
    sd1, r1 = idx.search(vecs[:10], k=3)
    sd2, r2 = idx2.search(vecs[:10], k=3)
    np.testing.assert_array_equal(r1.numpy(), r2.numpy())
    np.testing.assert_array_equal(sd1.numpy(), sd2.numpy())
    assert not np.isin(r1.numpy(), [1, 2]).any()
    _, found = idx.search(new, k=1)
    np.testing.assert_array_equal(found.numpy()[:, 0], [900, 901])
