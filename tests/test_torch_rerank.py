"""Exact-rescore (rerank) side tape of the port, for quantized storage.

The cases of `tests/test_rerank.py` on `vss_tpu_torch`: the beam runs over
the int8 tape (the tape the `beam_search` kernel reads on the card), then
the ef-wide result pool is re-scored once against the full-precision side
tape. The reference's file builds with `method="exact"`, which the port
does not have yet; these build with the native builder, which nothing
asserted here depends on. The checkpoint round trip is left out: it needs
the storage layer.
"""
import numpy as np
import pytest
import torch

from vss_tpu_torch import HNSWConfig, HNSWIndex


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several workers share the machine: one intra-op thread each is the
    faster setting for the small eager ops of an insert wave."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clustered(n, d, seed=0, n_centers=32):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 255, (n_centers, d))
    x = centers[rng.integers(0, n_centers, n)] + rng.normal(0, 25, (n, d))
    return np.clip(x, 0, 255).astype(np.float32)


def _build(x, cfg):
    return HNSWIndex.build(x, cfg, method="native", device="cpu")


def _hits(rows, gt):
    rows = rows.numpy()
    return sum(len(set(a[a >= 0].tolist()) & set(b.tolist())) for a, b in zip(rows, gt)) / gt.size


def _recall(idx, queries, gt, k, ef):
    _, rows = idx.search(queries, k=k, ef=ef)
    return _hits(rows, gt)


def _gt(vecs, queries, k):
    d = ((queries[:, None, :] - vecs[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def test_rerank_tape_allocated_for_int8_only():
    x = _clustered(256, 16)
    i8 = _build(x, HNSWConfig(dims=16, storage_dtype="int8"))
    f32 = _build(x, HNSWConfig(dims=16))
    assert i8.rerank_tape is not None
    assert i8.rerank_tape.shape == i8.graph.vectors.shape
    assert i8.rerank_tape.dtype == torch.float32
    assert f32.rerank_tape is None  # auto resolves to none for f32
    off = _build(x, HNSWConfig(dims=16, storage_dtype="int8", rerank="none"))
    assert off.rerank_tape is None


def test_rerank_recovers_int8_recall():
    n, d, k, nq = 4000, 32, 10, 64
    x = _clustered(n, d, seed=1)
    rng = np.random.default_rng(2)
    q = x[rng.choice(n, nq, replace=False)] + rng.normal(0, 10, (nq, d)).astype(np.float32)
    q = np.clip(q, 0, 255).astype(np.float32)
    gt = _gt(x, q, k)
    base = _build(x, HNSWConfig(dims=d, storage_dtype="int8", rerank="none"))
    rr = _build(x, HNSWConfig(dims=d, storage_dtype="int8"))
    r_none = _recall(base, q, gt, k, ef=48)
    r_rr = _recall(rr, q, gt, k, ef=48)
    # the rescored pool can only re-order admissions, never lose them
    assert r_rr >= r_none - 1e-9
    assert r_rr >= 0.9


def test_rerank_distances_are_exact():
    """Rescored output distances come from the side tape: for byte data
    they match the f32 oracle (after the scale mapping), with no int8
    rounding error."""
    n, d, k = 1000, 24, 5
    x = _clustered(n, d, seed=3)
    q = x[:8] + 1.0
    idx = _build(x, HNSWConfig(dims=d, storage_dtype="int8"))
    dists, rows = idx.search(q, k=k, ef=64)
    dists, rows = dists.numpy(), rows.numpy()
    assert (rows >= 0).any()
    for b in range(q.shape[0]):
        for j in range(k):
            if rows[b, j] < 0:
                continue
            exact = float(((q[b] - x[rows[b, j]]) ** 2).sum())
            assert dists[b, j] == pytest.approx(exact, rel=1e-4)


def test_rerank_tape_follows_insert_delete_compact():
    d, k = 16, 5
    x = _clustered(600, d, seed=4)
    idx = _build(x[:400], HNSWConfig(dims=d, storage_dtype="int8"))
    idx.insert(x[400:], rowids=np.arange(400, 600))
    assert idx.rerank_tape.shape[0] == idx.graph.capacity
    idx.delete(list(range(0, 600, 3)))
    idx.compact()
    assert idx.rerank_tape.shape[0] == idx.graph.capacity
    alive = np.array([i for i in range(600) if i % 3 != 0])
    gt_local = _gt(x[alive], x[alive[:32]], k)
    _, rows = idx.search(x[alive[:32]], k=k, ef=96)
    assert _hits(rows, alive[gt_local]) >= 0.9
    # the permuted side tape must still mirror the quantized tape's slots:
    # slot s of both tapes holds the same (scaled) vector
    tape = idx.rerank_tape[: idx.next_slot].numpy()
    quant = idx.graph.vectors[: idx.next_slot].numpy().astype(np.float32)
    assert np.abs(tape - quant).max() <= 0.5 + 1e-6  # int8 rounding bound


def test_scale_drift_guard_and_requantize():
    """Inserts 10x out of the build-time int8 range must set the stats
    drift flag; compact() requantizes from the f32 side tape and restores
    recall on the shifted data."""
    n, d, k = 1500, 24, 5
    x = _clustered(n, d, seed=7)
    idx = _build(x, HNSWConfig(dims=d, storage_dtype="int8"))
    st = idx.stats()["quantization"]
    assert not st["scale_drift"] and st["out_of_range_inserts"] == 0
    # a 10x-magnitude cluster far outside the build distribution
    rng = np.random.default_rng(11)
    big = (2000.0 + rng.normal(0, 25, (200, d))).astype(np.float32)
    idx.insert(big, rowids=np.arange(n, n + 200))
    st = idx.stats()["quantization"]
    assert st["scale_drift"] and st["out_of_range_inserts"] == 200
    assert st["max_abs_seen"] >= 1900.0
    # before requantizing, all big rows clip to the same +127 corner:
    # searching near one of them cannot separate them. compact() fixes it.
    old_scale = idx.vector_scale
    idx.compact()
    assert idx.vector_scale > old_scale
    st = idx.stats()["quantization"]
    assert not st["scale_drift"] and st["out_of_range_inserts"] == 0
    _, rows = idx.search(big[:16], k=k, ef=96)
    assert _hits(rows, _gt(big, big[:16], k) + n) >= 0.9
    # the original corpus is still searchable after requantization
    _, rows0 = idx.search(x[:16], k=k, ef=96)
    assert _hits(rows0, _gt(x, x[:16], k)) >= 0.9
