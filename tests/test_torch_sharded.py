"""vss_tpu_torch.parallel.ShardedHNSWIndex on the CPU: the cases of
`tests/test_sharded.py` on the port.

The JAX package runs its sharded index over 8 virtual XLA:CPU devices;
the port places its shards on slots of `make_mesh(n, device="cpu")`, all
on the one CPU. `test_sharded_index_in_database` is ported in
`tests/test_torch_sql.py`; the cross-package comparisons are in
`tests/test_torch_sharded_parity.py`. Recall is held to the port's own
exact oracle with the reference's bars; distances to the oracle's within
the bars the reference states.
"""
import numpy as np
import pytest
import torch

from vss_tpu_torch import HNSWConfig
from vss_tpu_torch.index.dense import HNSWIndex
from vss_tpu_torch.ops import bruteforce_topk
from vss_tpu_torch.parallel import Mesh, ShardedHNSWIndex, make_mesh

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine; the eager insert waves run
    faster on one intra-op thread per worker (as in test_torch_crud.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh(n):
    return make_mesh(n, device=CPU)


def recall(ids, true_ids):
    hits = sum(
        len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist()))
        for a, b in zip(ids, true_ids)
    )
    return hits / true_ids[true_ids >= 0].size


def truth(q, x, k):
    d, i = bruteforce_topk(torch.from_numpy(q), torch.from_numpy(x), k, "l2sq", device=CPU)
    return d.numpy(), i.numpy()


def test_mesh_has_8_slots():
    m = mesh(8)
    assert m.size == 8 and set(m.devices) == {torch.device(CPU)}
    # the default: one slot per visible device of the type, here the CPU
    assert make_mesh(device=CPU).size == 1
    assert Mesh(["cpu"] * 3).size == 3
    with pytest.raises(ValueError):
        make_mesh(0, device=CPU)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_build_and_search(rng, n_shards):
    n, d, k = 4000, 32, 10
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    idx = ShardedHNSWIndex.build(vecs, HNSWConfig(dims=d), mesh(n_shards), wave_size=256)
    q = rng.standard_normal((64, d)).astype(np.float32)
    sd, sr = idx.search(q, k=k, ef=64)
    r = recall(sr.numpy(), truth(q, vecs, k)[1])
    assert r >= 0.90, f"S={n_shards} recall {r}"
    # merged distances ascending
    assert np.all(np.diff(sd.numpy(), axis=1) >= -1e-6)


def test_sharded_matches_each_shard_rowids(rng):
    """Every returned rowid must be a real row; exact hit on self-query."""
    n, d = 1000, 16
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    idx = ShardedHNSWIndex.build(vecs, HNSWConfig(dims=d), mesh(4), wave_size=128)
    sd, sr = idx.search(vecs[:32], k=1, ef=64)
    assert sr[:, 0].tolist() == list(range(32))
    np.testing.assert_allclose(sd.numpy()[:, 0], 0.0, atol=1e-5)


def test_sharded_empty_raises():
    idx = ShardedHNSWIndex(HNSWConfig(dims=4), mesh(2))
    with pytest.raises(ValueError, match="empty"):
        idx.search(np.zeros((1, 4), np.float32), k=1)
    with pytest.raises(ValueError, match="empty"):
        idx.scan_search(np.zeros((1, 4), np.float32), k=1)


def test_sharded_crud_and_persistence(rng, tmp_path):
    n, d = 600, 16
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    idx = ShardedHNSWIndex.build(vecs, HNSWConfig(dims=d), mesh(4), wave_size=64)

    # insert
    nv = rng.standard_normal((10, d)).astype(np.float32)
    idx.insert(nv, np.arange(5000, 5010))
    assert idx.count == 610
    sd, sr = idx.search(nv, k=1, ef=64)
    assert sorted(sr[:, 0].tolist()) == list(range(5000, 5010))

    # delete: tombstoned rows excluded
    assert idx.delete([5000, 5001]) == 2
    assert idx.count == 608
    sd, sr = idx.search(nv[:2], k=3, ef=64)
    assert not ({5000, 5001} & set(sr.numpy().ravel().tolist()))

    # recycled insert
    idx.insert(nv[:2] + 9.0, [6000, 6001])
    assert idx.deleted_count == 0

    # delete + compact + requery
    idx.delete(list(range(0, 100)))
    idx.compact()
    assert idx.deleted_count == 0
    sd, sr = idx.search(vecs[100:110], k=1, ef=64)
    assert sr[:, 0].tolist() == list(range(100, 110))

    # save / load round trip
    p = str(tmp_path / "sharded_ckpt")
    idx.save(p)
    idx2 = ShardedHNSWIndex.load(p, mesh(4))
    assert idx2.count == idx.count
    sd1, sr1 = idx.search(vecs[200:232], k=5, ef=64)
    sd2, sr2 = idx2.search(vecs[200:232], k=5, ef=64)
    np.testing.assert_array_equal(sr1.numpy(), sr2.numpy())
    # the default mesh of a load: the checkpoint's shard count
    assert ShardedHNSWIndex.load(p, device=CPU).n_shards == 4

    # mismatched mesh size on load
    with pytest.raises(ValueError, match="shards"):
        ShardedHNSWIndex.load(p, mesh(2))


def test_sharded_duplicate_rowid(rng):
    vecs = rng.standard_normal((100, 8)).astype(np.float32)
    idx = ShardedHNSWIndex.build(vecs, HNSWConfig(dims=8), mesh(2), wave_size=32)
    with pytest.raises(ValueError, match="duplicate rowid"):
        idx.insert(vecs[:1], [5])


def test_sharded_int8(rng):
    """int8 tapes on the sharded index: global scale, rescaled distances,
    recall comparable to f32."""
    vecs = rng.uniform(0, 255, (600, 16)).astype(np.float32)
    idx = ShardedHNSWIndex.build(vecs, HNSWConfig(dims=16, storage_dtype="int8"), mesh(4),
                                 wave_size=64)
    assert idx.vector_scale > 1.0
    q = vecs[:32] + 0.5
    d, rows = idx.search(q, k=5)
    gt_d, gt_i = truth(q, vecs, 5)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(rows.numpy(), gt_i))
    assert hits / (32 * 5) >= 0.8
    # distances are in real (unscaled) units
    assert abs(float(d[0][0]) - float(gt_d[0][0])) < max(1.0, 0.05 * float(gt_d[0][0]) + 50)


def test_sharded_filter_mask(rng):
    vecs = rng.standard_normal((400, 8)).astype(np.float32)
    idx = ShardedHNSWIndex.build(vecs, HNSWConfig(dims=8), mesh(4), wave_size=64)
    # allow only even rowids; the mask may be numpy or a tensor
    srow = idx.slot_rowid_array()
    assert srow.shape == (4, idx.graphs[0].capacity)
    mask = (srow % 2 == 0) & (srow >= 0)
    for m in (mask, torch.from_numpy(mask)):
        d, rows = idx.search(vecs[:16], k=5, filter_mask=m)
        rows = rows.numpy()
        assert np.all(rows[rows >= 0] % 2 == 0)
        assert (rows >= 0).sum() >= 16 * 3  # plenty of even rows reachable


def test_sharded_rebalance_after_skewed_deletes(rng):
    vecs = rng.standard_normal((400, 8)).astype(np.float32)
    idx = ShardedHNSWIndex.build(vecs, HNSWConfig(dims=8), mesh(4), wave_size=64)
    # delete most rows living on shards 0 and 1 (round-robin: rowid % 4)
    dead = [r for r in range(400) if r % 4 in (0, 1) and r > 20]
    idx.delete(dead)
    counts = idx._live_counts()
    assert counts.max() - counts.min() > 0.25 * counts.mean()
    assert idx.rebalance()
    counts2 = idx._live_counts()
    assert counts2.max() - counts2.min() <= max(1, 0.25 * counts2.mean())
    assert idx.deleted_count == 0 and idx.count == 400 - len(dead)
    # search still healthy and excludes deleted rows
    d, rows = idx.search(vecs[:8], k=3)
    rows = rows.numpy()
    assert np.all(~np.isin(rows[rows >= 0], np.asarray(dead)))


def test_sharded_compact_triggers_rebalance(rng):
    vecs = rng.standard_normal((200, 8)).astype(np.float32)
    idx = ShardedHNSWIndex.build(vecs, HNSWConfig(dims=8), mesh(4), wave_size=64)
    idx.delete([r for r in range(200) if r % 4 == 0])  # all of shard 0
    idx.compact()
    assert idx.deleted_count == 0
    counts = idx._live_counts()
    assert counts.max() - counts.min() <= max(1, 0.3 * counts.mean())


def test_sharded_int8_rerank_parity_with_single_shard(rng):
    """The sharded index carries the f32 rescore side tape, so sharded
    int8 recall matches the single index's at equal per-shard ef."""
    n, d, k, ef = 3000, 24, 10, 64
    vecs = rng.uniform(0, 255, (n, d)).astype(np.float32)
    q = rng.uniform(0, 255, (64, d)).astype(np.float32)
    cfg = HNSWConfig(dims=d, storage_dtype="int8")
    gt = truth(q, vecs, k)[1]

    sidx = ShardedHNSWIndex.build(vecs, cfg, mesh(4), wave_size=256)
    assert sidx.rerank_tapes is not None  # int8 -> side tape exists
    # scale_ef=False: the side tape's effect at EQUAL per-shard beam width
    _, sr = sidx.search(q, k=k, ef=ef, scale_ef=False)
    r_sharded = recall(sr.numpy(), gt)

    uidx = HNSWIndex.build(vecs, cfg, wave_size=256, method="wave", device=CPU)
    _, ur = uidx.search(q, k=k, ef=ef)
    r_single = recall(ur.numpy(), gt)
    assert r_sharded >= r_single - 0.005, (r_sharded, r_single)


def test_sharded_rebalance_is_lossless_for_int8(rng):
    """rebalance() rebuilds from the f32 side tape: the int8 values after
    a rebalance equal a fresh build over the same live rows (no double
    quantization)."""
    n, d = 480, 12
    vecs = rng.uniform(-100, 100, (n, d)).astype(np.float32)
    cfg = HNSWConfig(dims=d, storage_dtype="int8")
    idx = ShardedHNSWIndex.build(vecs, cfg, mesh(4), wave_size=64)
    dead = [r for r in range(n) if r % 4 in (0, 1) and r > 16]
    idx.delete(dead)
    assert idx.rebalance()
    live = np.asarray(sorted(set(range(n)) - set(dead)))
    fresh = ShardedHNSWIndex.build(vecs[live], cfg, mesh(4), rowids=live.astype(np.int64),
                                   wave_size=64)
    assert abs(idx.vector_scale - fresh.vector_scale) < 1e-6
    # compare quantized values row by row via the rowid map
    for r in live[:50].tolist():
        s1, sl1 = idx.rowid_to_loc[r]
        s2, sl2 = fresh.rowid_to_loc[r]
        np.testing.assert_array_equal(idx.graphs[s1].vectors[sl1].numpy(),
                                      fresh.graphs[s2].vectors[sl2].numpy())


def test_sharded_rerank_tape_follows_crud(rng, tmp_path):
    """insert/delete/save/load keep the side tape consistent with the
    quantized tape (values match after dequantization)."""
    n, d = 300, 8
    vecs = rng.uniform(-50, 50, (n, d)).astype(np.float32)
    cfg = HNSWConfig(dims=d, storage_dtype="int8")
    idx = ShardedHNSWIndex.build(vecs, cfg, mesh(2), wave_size=64)
    extra = rng.uniform(-50, 50, (20, d)).astype(np.float32)
    idx.insert(extra, np.arange(n, n + 20))
    rt = [t.numpy() for t in idx.rerank_tapes]
    for i in range(20):
        s, sl = idx.rowid_to_loc[n + i]
        np.testing.assert_allclose(rt[s][sl] * idx.vector_scale, extra[i], rtol=1e-5,
                                   atol=1e-3)
    p = str(tmp_path / "shidx")
    idx.save(p)
    idx2 = ShardedHNSWIndex.load(p, mesh(2))
    assert idx2.rerank_tapes is not None
    # capacities differ after a load (serialize trims to next_slot); the
    # occupied prefix must round-trip exactly
    for s in range(2):
        ns = idx.next_slot[s]
        np.testing.assert_allclose(idx2.rerank_tapes[s].numpy()[:ns], rt[s][:ns])


def test_sharded_scan_search_matches_bruteforce(rng):
    """The sharded exact-scan serving path (per-shard scan_topk + merge).
    With the f32 side tape the result is exact w.r.t. the original
    vectors."""
    n, d, k = 4000, 32, 10
    vecs = rng.uniform(0, 255, (n, d)).astype(np.float32)
    q = rng.uniform(0, 255, (48, d)).astype(np.float32)
    idx = ShardedHNSWIndex.build(vecs, HNSWConfig(dims=d, storage_dtype="int8"), mesh(4),
                                 wave_size=256)
    d_s, rows, stats = idx.scan_search(q, k, with_stats=True)
    r = recall(rows.numpy(), truth(q, vecs, k)[1])
    assert r >= 0.99, r
    assert np.all(np.diff(d_s.numpy(), axis=1) >= -1e-6)
    # each shard streams only ITS tape: bytes/shard ~ (n/S)*d
    assert stats["per_shard_bytes"] < 2 * (n / 4) * d + 64 * d


def test_sharded_scan_search_excludes_deleted_and_filtered(rng):
    n, d, k = 1000, 16, 5
    vecs = rng.uniform(0, 255, (n, d)).astype(np.float32)
    idx = ShardedHNSWIndex.build(vecs, HNSWConfig(dims=d, storage_dtype="int8"), mesh(2),
                                 wave_size=128)
    # delete the exact nearest rows of the first 8 queries (self-rows)
    idx.delete(list(range(8)))
    _, rows = idx.scan_search(vecs[:8], k)
    assert set(rows.numpy().ravel().tolist()).isdisjoint(set(range(8)))
    # filter mask: only even rowids allowed
    srow = idx.slot_rowid_array()
    mask = (srow % 2 == 0) & (srow >= 0)
    _, rows2 = idx.scan_search(vecs[8:16], k, filter_mask=mask)
    r2 = rows2.numpy()
    assert np.all((r2 % 2 == 0) | (r2 < 0))


def _clustered(rng, n, nq, d):
    nc = 64
    centers = rng.uniform(0, 255, (nc, d))
    vecs = np.clip(centers[rng.integers(0, nc, n)] + rng.normal(0, 25, (n, d)), 0, 255)
    q = np.clip(centers[rng.integers(0, nc, nq)] + rng.normal(0, 25, (nq, d)), 0, 255)
    return vecs.astype(np.float32), q.astype(np.float32)


@pytest.mark.parametrize("corpus", ["clustered", "iid"])
def test_sharded_scaled_ef_recall_holds_and_work_drops(rng, corpus):
    """Per-shard ef shrinks with the shard count (`scale_ef=True`, the
    default) and the per-shard distance evaluations drop well below the
    full beam's. On the clustered corpus of the scaling workload global
    recall stays within 1 pt of the full-beam result (the reference's
    bar). An iid standard-normal corpus has no locally nearest rows for a
    narrow beam to find first: there the scaled beam gives up about 2 pt
    at this size (0.981 against 1.0), and is held within 3 pt and above
    0.95; deeper beams there take `scale_ef=False` or a larger ef."""
    n, d, k, ef = 8000, 32, 10, 64
    if corpus == "clustered":
        vecs, q = _clustered(rng, n, 64, d)
    else:
        vecs = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((64, d)).astype(np.float32)
    idx = ShardedHNSWIndex.build(vecs, HNSWConfig(dims=d), mesh(8), wave_size=256)
    gt = truth(q, vecs, k)[1]
    _, r_full, st_full = idx.search(q, k=k, ef=ef, scale_ef=False, with_stats=True)
    _, r_sc, st_sc = idx.search(q, k=k, ef=ef, with_stats=True)
    rec_full = recall(r_full.numpy(), gt)
    rec_sc = recall(r_sc.numpy(), gt)
    assert st_sc["ef_shard"] == idx.shard_ef(ef, k) == 16 < ef
    assert st_full["ef_shard"] == ef
    if corpus == "clustered":
        assert rec_sc >= rec_full - 0.01, (rec_sc, rec_full)
    else:
        assert rec_sc >= max(0.95, rec_full - 0.03), (rec_sc, rec_full)
    assert st_sc["per_shard_evals"].shape == (8,)
    ev_full = int(st_full["per_shard_evals"].sum())
    ev_sc = int(st_sc["per_shard_evals"].sum())
    # beam iteration bound ~ 4 + 2*ef: ef 64 -> 16 should cut evals ~3x
    assert ev_sc < 0.55 * ev_full, (ev_sc, ev_full)


def test_sharded_stats_and_tensor_inputs(rng):
    """stats() aggregates the shards (n_shards, counts, per-level
    nodes); queries and inserts may come as tensors; results land on the
    index's device."""
    n, d = 500, 8
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    idx = ShardedHNSWIndex.build(vecs, HNSWConfig(dims=d), mesh(4), wave_size=64)
    idx.insert(torch.from_numpy(vecs[:3] + 20.0), [900, 901, 902])
    idx.delete([0, 1])
    st = idx.stats()
    assert st["n_shards"] == 4 and st["count"] == n + 1 and st["deleted"] == 2
    assert st["levels"][0]["nodes"] == n + 1
    assert st["capacity"] == sum(idx.graphs[s].capacity - 8 for s in range(4))
    d_, rows = idx.search(torch.from_numpy(vecs[5]), k=1)
    assert rows.device == idx.device and rows.tolist() == [[5]]



def test_insert_wave_seeds_from_nearer_pivots(monkeypatch):
    """`_insert_wave_core(pivots=...)`, which the sharded insert passes:
    where the greedy descent ends far from a new node (here it is made to
    end in the other of two far-apart clusters, as on bulk-built graphs
    whose upper levels join no clusters), the node is seeded from its
    nearest pivot and links into its own cluster; without pivots it
    links where the descent left it."""
    import vss_tpu_torch.index.build as build_mod
    from vss_tpu_torch.index.dense import graph_pivots
    from vss_tpu_torch.index.exact_build import build_graph_exact
    from vss_tpu_torch.ops.gather import gather_distances

    rng = np.random.default_rng(0)
    d = 8
    vecs = np.concatenate([rng.normal(0, 1, (300, d)), rng.normal(40, 1, (300, d))])
    cfg = HNSWConfig(dims=d, m=4, ef_construction=4)
    g, used = build_graph_exact(vecs.astype(np.float32), cfg, seed=1, capacity=700, device=CPU)
    far = torch.tensor(450, dtype=torch.int32)  # a row of the second cluster
    real_descent = build_mod.greedy_descent

    def lost_descent(graph, config, q, **kw):
        seeds, _ = real_descent(graph, config, q, **kw)
        seeds = torch.full_like(seeds, int(far))
        return seeds, gather_distances(graph.vectors, seeds[:, None], q, config.metric)[:, 0]

    monkeypatch.setattr(build_mod, "greedy_descent", lost_descent)
    new = rng.normal(0, 1, (4, d)).astype(np.float32)  # near the first cluster
    lv = np.zeros(4, np.int32)
    ur, _ = build_mod.plan_wave_rows(lv, used, cfg.max_levels)
    args = (cfg, new, np.arange(600, 604), lv, ur, np.arange(600, 604), np.ones(4, bool), 4, 4, 4)
    seeded = build_mod._insert_wave_core(g.clone(), *args, pivots=graph_pivots(g))
    lost = build_mod._insert_wave_core(g.clone(), *args)
    links = seeded.adj0[600:604].numpy()
    assert ((links >= 0) & (links < 300) | (links >= 600) | (links < 0)).all()
    assert ((links >= 0) & (links < 300)).sum(1).min() >= 1
    lost_links = lost.adj0[600:604].numpy()
    assert ((lost_links >= 300) & (lost_links < 600)).any()
