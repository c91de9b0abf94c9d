"""SQL parity between the two packages: the same integer-valued numpy
tables and the same SQL statements go through `vss_tpu.Database` (the
JAX reference, on the CPU) and `vss_tpu_torch.Database(device="cpu")`.

For every statement the `EXPLAIN` text must be equal, the row ids equal
and the distances within 1e-5 of the terms' magnitude (|q|^2 + |x|^2 for
l2sq, 1 for cosine), the tolerance `chip_smoke.py` states for its kernel
checks. The vectors are integers in [-300, 300]^8: every f32 product and
sum is exact in both packages, and distances between distinct rows are
far apart, so the two indexes make the same decisions and no ties
reorder. Both build their graphs with the same native builder on one
thread (`auto` at this size), from the same seed.

One divergence is documented and held apart: at the exact-scan top-k on
small tapes at large k (ROADMAP fault C1), the JAX package's Pallas
`scan_topk` caps its winnow below k and misses true neighbours, and the
port does not. So the exact scan at k=100 is held to the exact oracle
(KNN_JOIN over an un-indexed copy), not to the JAX package. (On the CPU
the JAX package's SQL path takes its XLA scan, which reached the oracle
here too.)
"""
import numpy as np
import pytest
import torch

import vss_tpu
import vss_tpu_torch

N, NQ, D, LO, HI = 3000, 16, 8, -300, 300


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lit(v) -> str:
    return "[" + ", ".join(f"{float(x):.1f}" for x in v) + f"]::FLOAT[{D}]"


def make_data(seed=11):
    rng = np.random.default_rng(seed)
    vecs = rng.integers(LO, HI + 1, (N, D)).astype(np.float32)
    queries = rng.integers(LO, HI + 1, (NQ, D)).astype(np.float32)
    return vecs, queries


class Pair:
    """The same catalog in both packages; `sql` runs a statement in both."""

    def __init__(self, vecs, queries):
        self.jax = vss_tpu.Database()
        self.port = vss_tpu_torch.Database(device="cpu")
        self.magnitude = 2 * float((np.concatenate([vecs, queries]) ** 2).sum(1).max())
        for db in (self.jax, self.port):
            db.create_table("items", {"id": np.arange(N, dtype=np.int64), "vec": vecs})
            db.create_table("bare", {"id": np.arange(N, dtype=np.int64), "vec": vecs})
            db.create_table("queries", {"qid": np.arange(NQ, dtype=np.int64),
                                        "qvec": queries})

    def sql(self, text):
        return self.jax.sql(text), self.port.sql(text)

    def explain(self, text, op):
        a, b = self.sql("EXPLAIN " + text)
        assert a["explain"][0] == b["explain"][0]
        assert op in b["explain"][0], b["explain"][0]
        return b["explain"][0]

    def same(self, text, scale=None):
        """Run `text` in both; ids equal, floats within 1e-5 * scale."""
        a, b = self.sql(text)
        assert list(a) == list(b)
        scale = self.magnitude if scale is None else scale
        for c in a:
            x, y = np.asarray(a[c]), np.asarray(b[c])
            assert x.shape == y.shape, c
            if x.dtype.kind == "f":
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-5 * scale, err_msg=c)
            elif x.dtype == object:
                assert [np.asarray(v).tolist() for v in x] == \
                    [np.asarray(v).tolist() for v in y], c
            else:
                np.testing.assert_array_equal(x, y, err_msg=c)
        return b


@pytest.fixture(scope="module")
def data():
    return make_data()


@pytest.fixture
def pair(data):
    vecs, queries = data
    p = Pair(vecs, queries)
    p.sql("CREATE INDEX idx ON items USING HNSW (vec) WITH (metric = 'l2sq')")
    return p


def test_index_scan(pair, data):
    _, queries = data
    for q in queries[:6]:
        sql = (f"SELECT id, array_distance(vec, {lit(q)}) AS d FROM items "
               f"ORDER BY array_distance(vec, {lit(q)}) LIMIT 10")
        pair.explain(sql, "HNSW_INDEX_SCAN")
        r = pair.same(sql)
        assert len(r["id"]) == 10


def test_min_by(pair, data):
    _, queries = data
    sql = f"SELECT min_by(id, array_distance(vec, {lit(queries[0])}), 10) FROM items"
    pair.explain(sql, "HNSW_INDEX_SCAN")
    pair.same(sql)


def test_index_join(pair):
    sql = ("SELECT qid, id, array_distance(qvec, vec) AS d FROM queries, LATERAL "
           "(SELECT id, vec FROM items ORDER BY array_distance(queries.qvec, items.vec) "
           "LIMIT 10)")
    pair.explain(sql, "HNSW_INDEX_JOIN")
    r = pair.same(sql)
    assert len(r["id"]) == NQ * 10
    kj = "SELECT l_qid, r_id, row_number FROM knn_join(queries, items, qvec, vec, 5)"
    pair.explain(kj, "HNSW_INDEX_JOIN")
    pair.same(kj)


def test_cosine_expression_rule(data):
    vecs, queries = data
    p = Pair(vecs, queries)
    p.sql("CREATE INDEX cidx ON items USING HNSW (vec) WITH (metric = 'cosine')")
    q = lit(queries[1])
    sql = (f"SELECT id, array_cosine_distance(vec, {q}) AS d FROM items "
           f"ORDER BY 1.0 - array_cosine_similarity(vec, {q}) LIMIT 10")
    plan = p.explain(sql, "HNSW_INDEX_SCAN")
    assert "cidx" in plan
    p.same(sql, scale=1.0)


@pytest.mark.parametrize("k", [10, 100])
def test_brute_force_topk(pair, data, k):
    _, queries = data
    for q in queries[:3]:
        sql = (f"SELECT id, array_distance(vec, {lit(q)}) AS d FROM bare "
               f"ORDER BY array_distance(vec, {lit(q)}) LIMIT {k}")
        pair.explain(sql, "BRUTE_FORCE_TOPK")
        r = pair.same(sql)
        assert len(r["id"]) == k
    kj = f"SELECT l_qid, r_id FROM knn_join(queries, bare, qvec, vec, {k})"
    pair.explain(kj, "KNN_JOIN")
    pair.same(kj)


def test_vss_join_and_match(pair, data):
    _, queries = data
    pair.same("SELECT * FROM vss_join(queries, bare, qvec, vec, 10)")
    pair.same("SELECT * FROM vss_join(queries, bare, qvec, vec, 3, 'cosine')", scale=1.0)
    vec = "[" + ", ".join(f"{float(x):.1f}" for x in queries[2]) + "]"
    pair.same(f"SELECT * FROM vss_match(bare, {vec}, vec, 4)")


def test_pushed_filter(pair, data):
    _, queries = data
    sql = (f"SELECT id FROM items WHERE id >= 1500 "
           f"ORDER BY array_distance(vec, {lit(queries[3])}) LIMIT 10")
    plan = pair.explain(sql, "HNSW_INDEX_SCAN")
    assert "filtered" in plan
    r = pair.same(sql)
    assert len(r["id"]) == 10 and (r["id"] >= 1500).all()


def test_delete_and_compact(pair, data):
    _, queries = data
    join = ("SELECT qid, id FROM queries, LATERAL (SELECT id FROM items ORDER BY "
            "array_distance(queries.qvec, items.vec) LIMIT 10)")
    before = pair.same(join)
    gone = sorted(set(before["id"].tolist()))[:20]
    pair.sql(f"DELETE FROM items WHERE id <= {max(gone)} AND id >= {min(gone)}")
    r = pair.same(join)
    assert not set(r["id"].tolist()) & set(range(min(gone), max(gone) + 1))
    pair.sql("PRAGMA hnsw_compact_index('idx')")
    assert pair.port.indexes["idx"].index.deleted_count == 0
    r = pair.same(join)
    assert not set(r["id"].tolist()) & set(range(min(gone), max(gone) + 1))
    pair.same(f"SELECT id FROM items ORDER BY array_distance(vec, {lit(queries[0])}) "
              "LIMIT 10")
    pair.same("SELECT * FROM pragma_hnsw_index_info()")


def test_update(pair):
    target = [299.0, -299.0] * (D // 2)
    pair.sql(f"UPDATE items SET vec = {lit(target)} WHERE id = 7")
    sql = (f"SELECT id, array_distance(vec, {lit(target)}) AS d FROM items "
           f"ORDER BY array_distance(vec, {lit(target)}) LIMIT 10")
    pair.explain(sql, "HNSW_INDEX_SCAN")
    r = pair.same(sql)
    assert r["id"][0] == 7 and r["d"][0] == 0.0
    pair.same("SELECT count(*) FROM items")


@pytest.mark.parametrize("k", [10, 100])
def test_exact_scan_join_held_to_the_oracle(data, k):
    """The cost model on, an int8 index: for the batch of 16 queries both
    planners pick the exact scan over the index tape (EXACT_SCAN_JOIN,
    one `scan_search` call with keep = 2k). At k=10 the two packages
    agree. At k=100 on a 3,000-row tape, C1's regime, the port is held to
    the exact oracle (KNN_JOIN over the un-indexed table) and not to the
    JAX package, whose Pallas winnow caps keep below k there."""
    vecs, queries = data
    p = Pair(vecs, queries)
    p.sql("CREATE INDEX qidx ON items USING HNSW (vec) WITH (storage = 'int8')")
    p.sql("SET hnsw_cost_model = true")
    sql = f"SELECT l_qid, r_id FROM knn_join(queries, items, qvec, vec, {k})"
    p.explain(sql, "EXACT_SCAN_JOIN")
    oracle = p.port.sql(sql.replace("items", "bare"))
    got = p.same(sql) if k == 10 else p.port.sql(sql)
    np.testing.assert_array_equal(got["l_qid"], oracle["l_qid"])

    def dist(r):
        # exact: integer vectors; rows at equal distance may come in
        # either order (the rerank scores the scaled side tape)
        return ((vecs[r["r_id"]] - queries[r["l_qid"]]) ** 2).sum(1)

    np.testing.assert_array_equal(dist(got), dist(oracle))
