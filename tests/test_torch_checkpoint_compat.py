"""Checkpoints carried across the two packages, in both directions.

The shared `VSSTPU01` stream format, the database checkpoint (a directory
or a `.vssdb` block file) and the write-ahead log are the state this
slice carries: what `vss_tpu` (the JAX reference, on the CPU) writes,
`vss_tpu_torch` (on `device="cpu"`) reads, and the reverse, with equal
results, sharded indexes (`parallel/`) on four shard slots included.
Index streams cover f32, bf16 and int8 with its f32 rerank tape,
through `load_index` and the memory-mapped `view_index`; both the graph
`search` and the exact `scan_search` must return the saver's ids, with
distances within 1e-5 of the terms' magnitude. The vectors are integers
in [-300, 300]^8, so distinct rows lie far apart and no ties reorder.
"""
import numpy as np
import pytest
import torch

import vss_tpu
import vss_tpu.parallel
import vss_tpu.storage as jstorage
import vss_tpu_torch
import vss_tpu_torch.parallel
import vss_tpu_torch.storage as tstorage
from vss_tpu.index import HNSWConfig as JConfig
from vss_tpu.index.dense import HNSWIndex as JIndex
from vss_tpu_torch import HNSWConfig, HNSWIndex
from vss_tpu_torch.storage.blockfile import blockstore_available

N, D = 2000, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    vecs = rng.integers(-300, 301, (N, D)).astype(np.float32)
    queries = rng.integers(-300, 301, (12, D)).astype(np.float32)
    return vecs, queries


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def results(idx, queries):
    """(search ids, search dists, scan ids, scan dists) as numpy."""
    sd, si = idx.search(queries, k=10, ef=64)
    cd, ci = idx.scan_search(queries, k=10)
    return [_np(a) for a in (si, sd, ci, cd)]


def assert_same(got, want, scale):
    for g, w in zip(got[0::2], want[0::2]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[1::2], want[1::2]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale)


def _scale(vecs, queries):
    return 2 * float((np.concatenate([vecs, queries]) ** 2).sum(1).max())


def _history(idx, vecs):
    """Tombstones and a recycled insert, so the free ring, the scale
    fields and rowid_to_slot are carried too."""
    idx.delete(list(range(0, 40, 3)))
    idx.insert(vecs[:5] + 1.0, np.arange(5000, 5005))
    return idx


STORAGES = ["f32", "bf16", "int8"]


@pytest.mark.parametrize("storage", STORAGES)
def test_jax_stream_loads_in_port(data, storage, tmp_path):
    vecs, queries = data
    jidx = _history(JIndex.build(vecs, JConfig(dims=D, storage_dtype=storage)), vecs)
    p = str(tmp_path / "j.vss")
    jstorage.save_index(jidx, p)
    want = results(jidx, queries)
    for view in (False, True):
        tidx = tstorage.load_index(p, view=view, device="cpu")
        assert tidx.count == jidx.count
        assert tidx.rowid_to_slot == jidx.rowid_to_slot
        assert sorted(tidx.free_slots) == sorted(jidx.free_slots)
        assert tidx.vector_scale == jidx.vector_scale
        assert (tidx.rerank_tape is None) == (jidx.rerank_tape is None)
        assert_same(results(tidx, queries), want, _scale(vecs, queries))


@pytest.mark.parametrize("storage", STORAGES)
def test_port_stream_loads_in_jax(data, storage, tmp_path):
    vecs, queries = data
    tidx = _history(HNSWIndex.build(vecs, HNSWConfig(dims=D, storage_dtype=storage),
                                    device="cpu"), vecs)
    p = str(tmp_path / "t.vss")
    tstorage.save_index(tidx, p)
    want = results(tidx, queries)
    for view in (False, True):
        jidx = jstorage.load_index(p, view=view)
        assert jidx.count == tidx.count
        assert jidx.rowid_to_slot == tidx.rowid_to_slot
        assert jidx.vector_scale == tidx.vector_scale
        assert str(np.asarray(jidx.graph.vectors).dtype) == {
            "f32": "float32", "bf16": "bfloat16", "int8": "int8"}[storage]
        assert_same(results(jidx, queries), want, _scale(vecs, queries))


def test_streams_are_byte_equal(data, tmp_path):
    """The same index state written by both packages gives the same bytes:
    an index carried across and saved again round-trips exactly."""
    vecs, _ = data
    jidx = _history(JIndex.build(vecs, JConfig(dims=D, storage_dtype="int8")), vecs)
    pj, pt = str(tmp_path / "j.vss"), str(tmp_path / "t.vss")
    jstorage.save_index(jidx, pj)
    tstorage.save_index(tstorage.load_index(pj, device="cpu"), pt)
    assert open(pj, "rb").read() == open(pt, "rb").read()


PACKAGES = {
    "jax": lambda path=None: vss_tpu.Database(path),
    "port": lambda path=None: vss_tpu_torch.Database(path, device="cpu"),
}
OPEN = {
    "jax": lambda path: vss_tpu.Database.open(path),
    "port": lambda path: vss_tpu_torch.Database.open(path, device="cpu"),
}
MESH = {
    "jax": lambda: vss_tpu.parallel.make_mesh(4),
    "port": lambda: vss_tpu_torch.parallel.make_mesh(4, device="cpu"),
}
JOIN = ("SELECT qid, id, array_distance(qvec, vec) AS d FROM queries, LATERAL "
        "(SELECT id, vec FROM items ORDER BY array_distance(queries.qvec, items.vec) "
        "LIMIT 10)")


def _lit(v):
    return "[" + ", ".join(f"{float(x):.1f}" for x in v) + f"]::FLOAT[{D}]"


def _statements(queries):
    return [JOIN, "SELECT count(*) FROM items",
            f"SELECT id FROM items ORDER BY array_distance(vec, {_lit(queries[0])}) LIMIT 10",
            "SELECT name FROM items WHERE id < 5"]


def _run(db, queries):
    return [db.sql(s) for s in _statements(queries)]


def _same_results(a, b):
    for ra, rb in zip(a, b):
        assert list(ra) == list(rb)
        for c in ra:
            x, y = np.asarray(ra[c]), np.asarray(rb[c])
            if x.dtype.kind == "f":
                np.testing.assert_allclose(x, y, rtol=1e-6)
            else:
                np.testing.assert_array_equal(x, y)


def _make_db(kind, vecs, queries, storage, sharded=False):
    db = PACKAGES[kind]()
    db.create_table("items", {"id": np.arange(N, dtype=np.int64), "vec": vecs,
                              "name": np.asarray([f"r{i}" for i in range(N)], object)})
    db.create_table("queries", {"qid": np.arange(len(queries), dtype=np.int64),
                                "qvec": queries})
    db.sql("SET hnsw_enable_experimental_persistence = true")
    if sharded:
        db.create_hnsw_index("idx", "items", "vec", storage=storage, sharded=True,
                             mesh=MESH[kind]())
    else:
        db.sql(f"CREATE INDEX idx ON items USING HNSW (vec) WITH (storage = '{storage}')")
    db.sql("DELETE FROM items WHERE id < 30")
    return db


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("fmt", ["dir", "vssdb"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_database_checkpoint_opens_in_the_other(data, tmp_path, writer, reader, fmt,
                                                storage):
    if fmt == "vssdb" and not blockstore_available():
        pytest.skip("no C++ toolchain for the block store")
    vecs, queries = data
    db = _make_db(writer, vecs, queries, storage)
    want = _run(db, queries)
    path = str(tmp_path / ("db.vssdb" if fmt == "vssdb" else "db"))
    db.checkpoint(path)
    other = OPEN[reader](path)
    assert not other.indexes["idx"].loaded
    _same_results(_run(other, queries), want)
    plan = other.sql("EXPLAIN " + JOIN)["explain"][0]
    assert plan == db.sql("EXPLAIN " + JOIN)["explain"][0]
    assert "HNSW_INDEX_JOIN" in plan


@pytest.mark.parametrize("fmt", ["dir", "vssdb"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_sharded_database_checkpoint_opens_in_the_other(data, tmp_path, writer, reader, fmt):
    """A 4-shard int8 index: the directory form (`index_idx.sharded/`,
    one stream per shard) and the block file's `index:idx:shard<s>`
    streams, written by one package, open in the other on four slots with
    the same answers."""
    if fmt == "vssdb" and not blockstore_available():
        pytest.skip("no C++ toolchain for the block store")
    vecs, queries = data
    db = _make_db(writer, vecs, queries, "int8", sharded=True)
    want = _run(db, queries)
    path = str(tmp_path / ("db.vssdb" if fmt == "vssdb" else "db"))
    db.checkpoint(path)
    other = OPEN[reader](path)
    idx = other.indexes["idx"].index
    assert idx.n_shards == 4 and idx.count == N - 30 and idx.deleted_count == 30
    assert idx.rowid_to_loc == db.indexes["idx"].index.rowid_to_loc
    _same_results(_run(other, queries), want)
    plan = other.sql("EXPLAIN " + JOIN)["explain"][0]
    assert plan == db.sql("EXPLAIN " + JOIN)["explain"][0]
    assert "HNSW_INDEX_JOIN" in plan


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_wal_replays_in_the_other(data, tmp_path, writer, reader):
    vecs, queries = data
    db = _make_db(writer, vecs, queries, "f32")
    path = str(tmp_path / "db")
    db.checkpoint(path)
    db.enable_wal()
    # logged after the checkpoint: an insert, a delete, an update
    db.insert("items", {"id": [9000, 9001], "vec": [[299.0] * D, [-299.0] * D],
                        "name": ["a", None]})
    db.delete("items", [100, 101, 102])
    db.update("items", [200], {"vec": np.full((1, D), 150.0, np.float32)})
    want = _run(db, queries)
    other = OPEN[reader](path)  # the writer never checkpointed again
    _same_results(_run(other, queries), want)
    r = other.sql(f"SELECT id FROM items ORDER BY array_distance(vec, "
                  f"{_lit([299.0] * D)}) LIMIT 1")
    assert r["id"][0] == 9000
    r = other.sql(f"SELECT id FROM items ORDER BY array_distance(vec, "
                  f"{_lit([150.0] * D)}) LIMIT 1")
    assert r["id"][0] == 200
    assert other.sql("SELECT count(*) FROM items WHERE id >= 100 AND id <= 102"
                     )["count"][0] == 0
