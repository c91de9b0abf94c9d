"""ShardedHNSWIndex across the two packages: the same numpy inputs through
`vss_tpu.parallel` on `make_mesh(4)` (four of the virtual XLA:CPU devices
of `tests/conftest.py`) and through `vss_tpu_torch.parallel` on
`make_mesh(4, device="cpu")` (four slots on the CPU).

The vectors are small integers, so every f32 product, norm and distance
is exact in both packages and both break ties by the lower position: the
wave-built shards must be equal array for array, and so must the shards
after a scripted insert / delete / compact / rebalance history (within
the assigned slots and upper rows: the JAX package's bulk builder writes
pad rows into its scatter sinks, which nothing reads). Search and scan
ids must be equal with and without a filter mask, distances within rtol
1e-5, atol 1e-4, and the per-shard distance-evaluation counts and the
per-shard ef equal. int8 indexes take vectors whose largest |value| is
254, so the scale is exactly 2 in both packages.

The port seeds each shard's beam from the shard's pivots, as
`HNSWIndex.search` does in both packages, and its insert waves from them
where they are nearer than the greedy descent's end; the JAX package's
sharded index runs greedy descent alone (ROADMAP fault C3). Its search
is therefore held to the JAX package's own pieces put together the same
way (`jax_search`: per shard, the JAX `HNSWIndex`'s pivots and
`hnsw_search` with its counters, then `merge_topk` in shard order), and
the write history runs with the port's pivots switched off;
`tests/test_torch_sharded_exact.py` pins the recall the JAX package's
sharded search loses on a clustered corpus. The exact scan is held to
the JAX package's sharded `scan_search` directly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vss_tpu.index.dense import rescale_distances as j_rescale
from vss_tpu.index.graph import HNSWConfig as JConfig
from vss_tpu.index.search import hnsw_search as j_hnsw_search
from vss_tpu.ops.topk import merge_topk as j_merge_topk
from vss_tpu.parallel import ShardedHNSWIndex as JSharded
from vss_tpu.parallel import make_mesh as jmesh
from vss_tpu_torch import HNSWConfig
from vss_tpu_torch.parallel import ShardedHNSWIndex, make_mesh

RTOL, ATOL = 1e-5, 1e-4
S, D = 4, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vectors(rng, n, storage):
    v = rng.integers(-12, 13, (n, D)).astype(np.float32)
    if storage == "int8":
        v = v * 20.0
        v[0, 0] = 254.0  # the scale: 254 / 127 = 2 exactly
    return v


def _cfg(storage):
    kw = dict(dims=D, m=4, ef_construction=24, ef_search=24, storage_dtype=storage)
    return JConfig(**kw), HNSWConfig(**kw)


def _build(vecs, storage, **kw):
    jc, tc = _cfg(storage)
    j = JSharded.build(vecs, jc, jmesh(S), **kw)
    t = ShardedHNSWIndex.build(vecs, tc, make_mesh(S, device="cpu"), **kw)
    return j, t


def assert_same_index(j, t, whole=True):
    """Bookkeeping, then every graph array of every shard. `whole=False`
    compares adjacency and vectors in the assigned slots and upper rows
    only."""
    assert j.n_shards == t.n_shards == S
    assert (j.count, j.deleted_count, j.vector_scale) == (t.count, t.deleted_count,
                                                          t.vector_scale)
    assert j.next_slot == t.next_slot and j.upper_used == t.upper_used
    assert j.free_slots == t.free_slots and j.shard_deleted == t.shard_deleted
    assert j.rowid_to_loc == t.rowid_to_loc
    assert (j._insert_seed, j._insert_counter) == (t._insert_seed, t._insert_counter)
    for f in dataclasses.fields(j.graphs):
        ja = np.asarray(getattr(j.graphs, f.name))
        for s in range(S):
            ta = getattr(t.graphs[s], f.name).numpy()
            js = ja[s]
            if not whole and f.name in ("adj0", "vectors"):
                js, ta = js[: j.next_slot[s]], ta[: t.next_slot[s]]
            elif not whole and f.name == "upper_adj":
                js, ta = js[: j.upper_used[s]], ta[: t.upper_used[s]]
            np.testing.assert_array_equal(ta, js, err_msg=f"{f.name} of shard {s}")
    assert (j.rerank_tapes is None) == (t.rerank_tapes is None)
    if j.rerank_tapes is not None:
        jr = np.asarray(j.rerank_tapes)
        for s in range(S):
            np.testing.assert_array_equal(t.rerank_tapes[s].numpy(), jr[s])


def jax_search(j, q, k, ef=None, scale_ef=True, filter_mask=None):
    """The port's sharded search from the JAX package's pieces: each
    shard as the JAX `HNSWIndex` (`_extract_shard`) searched the way its
    `search` does (pivot seeds, norm tape, side tape) through
    `hnsw_search` with the counters, at the per-shard ef, then the
    per-shard lists merged in shard order by `merge_topk`."""
    cfg = j.config
    qj = jnp.asarray(np.asarray(q, np.float32))
    if cfg.storage_dtype == "int8":
        qj = qj / j.vector_scale
    ef = max(ef or cfg.ef_search, k)
    ef_shard = j.shard_ef(ef, k) if scale_ef else ef
    ds, rs, evals = [], [], []
    for s in range(j.n_shards):
        shard = j._extract_shard(s)
        pivot_slots, pivot_vecs = shard.pivots()
        packed, packing = shard.packed_tape()
        d, slots, st = j_hnsw_search(
            shard.graph, cfg, qj, k, ef=ef_shard,
            filter_mask=None if filter_mask is None else jnp.asarray(filter_mask[s]),
            with_stats=True, assume_all_valid=j.deleted_count == 0 and filter_mask is None,
            pivot_slots=pivot_slots, pivot_vecs=pivot_vecs, x_norms=shard.norms(),
            packed_tape=packed, packing=packing, rerank_tape=shard.rerank_tape)
        ds.append(d)
        rs.append(jnp.where(slots >= 0, jnp.take(shard.graph.slot_to_rowid,
                                                 jnp.maximum(slots, 0)), -1))
        evals.append(st["distance_evals"])
    d, r = j_merge_topk(jnp.concatenate(ds, 1), jnp.concatenate(rs, 1), k)
    if cfg.storage_dtype == "int8":
        d = j_rescale(d, j.vector_scale, cfg.metric)
    return d, r, {"per_shard_evals": np.asarray(evals), "ef_shard": ef_shard}


def assert_same_results(j, t, q, k, seeded=True, **kw):
    """search (with its stats) and scan_search: ids equal, distances
    close. `seeded=False`: the port's pivots are switched off, and its
    search is held to the JAX package's sharded search itself."""
    if seeded:
        jd, jr, js = jax_search(j, q, k, **kw)
    else:
        jd, jr, js = j.search(q, k=k, with_stats=True, **kw)
    td, tr, ts = t.search(q, k=k, with_stats=True, **kw)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    assert ts["ef_shard"] == js["ef_shard"]
    np.testing.assert_array_equal(ts["per_shard_evals"], np.asarray(js["per_shard_evals"]))
    scan_kw = {"filter_mask": kw["filter_mask"]} if "filter_mask" in kw else {}
    jd, jr = j.scan_search(q, k, **scan_kw)
    td, tr = t.scan_search(q, k, **scan_kw)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_wave_built_shards_equal_jax(storage):
    rng = np.random.default_rng(31)
    vecs = _vectors(rng, 403, storage)  # 101, 101, 101, 100 rows: uneven shards
    j, t = _build(vecs, storage, wave_size=32, method="wave", seed=5)
    assert_same_index(j, t)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("scale_ef", [True, False])
def test_search_and_scan_equal_jax(masked, scale_ef):
    rng = np.random.default_rng(32)
    vecs = _vectors(rng, 600, "int8")
    q = _vectors(rng, 24, "f32") * 20.0
    j, t = _build(vecs, "int8", wave_size=64, method="wave")
    kw = {"scale_ef": scale_ef}
    if masked:
        srow = t.slot_rowid_array()
        np.testing.assert_array_equal(srow, j.slot_rowid_array())
        kw["filter_mask"] = (srow % 3 != 0) & (srow >= 0)
    assert_same_results(j, t, q, 5, **kw)
    assert_same_results(j, t, q[:3], 1, ef=48, **kw)


def test_crud_and_rebalance_history_equal_jax(monkeypatch):
    """A scripted history, both packages step by step: build (the bulk
    builder, `auto`), insert past the capacity, delete, an insert into
    recycled slots, a per-shard compaction, then deletes skewed onto two
    shards and the rebalance that compaction takes. The port's pivots are
    switched off (no shard has any), so its insert waves and searches
    seed by greedy descent, the JAX package's algorithm, and every array
    and result must be the JAX package's."""
    import vss_tpu_torch.parallel.sharded as sharded_mod

    monkeypatch.setattr(sharded_mod, "graph_pivots", lambda g: (None, None))
    rng = np.random.default_rng(33)
    vecs = _vectors(rng, 320, "int8")
    extra = _vectors(rng, 200, "int8")
    q = _vectors(rng, 16, "f32") * 20.0
    j, t = _build(vecs, "int8", seed=2)
    assert_same_index(j, t, whole=False)
    steps = [
        lambda x: x.insert(extra[:150], np.arange(1000, 1150)),
        lambda x: x.delete(list(range(0, 320, 7)) + [1003, 1010]),
        lambda x: x.insert(extra[150:], np.arange(2000, 2050)),
        lambda x: x.delete(list(range(1, 40))),
        lambda x: x.compact(),
        lambda x: x.delete([r for r in range(320) if r % 4 in (0, 1)]),
        lambda x: x.compact(),
    ]
    for i, step in enumerate(steps):
        assert step(j) == step(t), f"step {i}"
        assert_same_index(j, t, whole=False)
        assert_same_results(j, t, q, 5, seeded=False)
    assert t.deleted_count == 0 and t.count == j.count
    counts = t._live_counts()
    assert counts.max() - counts.min() <= 1  # the rebalance ran



def test_seeded_insert_and_search_from_jax_pieces():
    """With the pivots on (the default), an insert seeds its wave from
    each shard's pivots, which the JAX package has no counterpart for: the
    bookkeeping, the slots and the side tapes stay the JAX package's, and
    the searches afterwards equal the JAX pieces' (`jax_search`) over the
    port's own shards carried across as JAX indexes."""
    from vss_tpu.index.graph import HNSWGraph as JGraph

    rng = np.random.default_rng(34)
    vecs = _vectors(rng, 320, "int8")
    extra = _vectors(rng, 120, "int8")
    q = _vectors(rng, 16, "f32") * 20.0
    j, t = _build(vecs, "int8", seed=2)
    for x in (j, t):
        x.delete(list(range(0, 320, 9)))
        x.insert(extra, np.arange(1000, 1120))
    assert (j.rowid_to_loc, j.next_slot, j.free_slots) == (t.rowid_to_loc, t.next_slot,
                                                           t.free_slots)
    for s in range(S):
        np.testing.assert_array_equal(t.rerank_tapes[s].numpy(), np.asarray(j.rerank_tapes)[s])
        np.testing.assert_array_equal(t.graphs[s].slot_to_rowid.numpy(),
                                      np.asarray(j.graphs.slot_to_rowid)[s])
    # the port's shards, carried into the JAX index, searched the JAX way
    j.graphs = JGraph(**{f.name: jnp.stack([jnp.asarray(getattr(t.graphs[s], f.name).numpy())
                                            for s in range(S)])
                         for f in dataclasses.fields(JGraph)})
    assert_same_results(j, t, q, 5)
