"""The query layer of vss_tpu_torch on the CPU: plan rewrites, execution,
filter pushdown, reader concurrency, lazy index loading, the cost model
and the single-file database.

Ports `tests/test_query.py` (23 tests), `tests/test_pushdown.py` (5),
`tests/test_concurrency.py` (3), `tests/test_cost_model.py` (9) and
`tests/test_native.py`'s two `Database` tests to the port, each file as a
class of the same tests, on `Database(device="cpu")`. The cost model's
tests hold the port to its own rates, measured on an H100 by
`calibrate()`; where the choice differs from the JAX package's TPU fits,
the test says why.
"""
import os
import threading

import numpy as np
import pytest
import torch

from vss_tpu_torch import BinderError, Database, col, const, fn, vss_join, vss_match
from vss_tpu_torch.query.cost import prefer_exact
from vss_tpu_torch.query.ir import BinOp

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine; the eager insert waves run
    faster on one intra-op thread per worker (as in test_torch_crud.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def grid_729():
    g = np.stack(
        np.meshgrid(np.arange(9), np.arange(9), np.arange(9), indexing="ij"), -1
    ).reshape(-1, 3)
    return g.astype(np.float32)


def dist_q(q):
    return fn("array_distance", col("vec"), const(np.asarray(q, np.float32)))


class TestQuery:
    """Ports `tests/test_query.py`."""

    @pytest.fixture
    def db(self):
        d = Database(device=CPU)
        vecs = grid_729()
        d.create_table("items", {"id": np.arange(729, dtype=np.int64), "vec": vecs})
        d.create_hnsw_index("my_idx", "items", "vec", metric="l2sq", seed=0)
        return d

    def test_topn_rewrites_to_index_scan(self, db):
        q = db.query("items").order_by(dist_q([5, 5, 5])).limit(3).select("id")
        plan = q.explain()
        assert "HNSW_INDEX_SCAN" in plan
        assert "TOP_N" not in plan

    def test_729_result_parity(self, db):
        """hnsw_result.test analog: distances 0, 1, 1 for [5,5,5] top-3."""
        q = (
            db.query("items")
            .order_by(dist_q([5, 5, 5]))
            .limit(3)
            .select("id", dist=dist_q([5, 5, 5]))
        )
        res = q.execute()
        np.testing.assert_allclose(sorted(res["dist"]), [0.0, 1.0, 1.0], atol=1e-6)
        assert res["id"][0] == 5 * 81 + 5 * 9 + 5

    def test_indexed_matches_unoptimized(self, db):
        """Labeled-result equivalence (hnsw_rewrite.test analog)."""
        for target in ([1.0, 2.0, 3.0], [8.0, 8.0, 8.0], [4.4, 4.6, 4.5]):
            q = (
                db.query("items")
                .order_by(dist_q(target))
                .limit(5)
                .select("id", dist=dist_q(target))
            )
            with_idx = q.execute()
            no_idx = q.execute_unoptimized()
            np.testing.assert_allclose(
                with_idx["dist"], no_idx["dist"], atol=1e-5
            )

    def test_no_index_uses_brute_force_kernel(self, db):
        """Un-indexed distance TopN lowers to the exact brute-force operator."""
        db2 = Database(device=CPU)
        db2.create_table("t", {"id": np.arange(729), "vec": grid_729()})
        q = db2.query("t").order_by(dist_q([5, 5, 5])).limit(3).select("id")
        assert "BRUTE_FORCE_TOPK" in q.explain()
        res = q.execute()
        assert res["id"][0] == 5 * 81 + 5 * 9 + 5

    def test_descending_not_rewritten(self, db):
        q = (
            db.query("items")
            .order_by(dist_q([5, 5, 5]), ascending=False)
            .limit(3)
            .select("id")
        )
        assert "HNSW_INDEX_SCAN" not in q.explain()

    def test_wrong_metric_not_rewritten(self, db):
        q = (
            db.query("items")
            .order_by(fn("array_cosine_distance", col("vec"), const(np.ones(3, np.float32))))
            .limit(3)
            .select("id")
        )
        assert "HNSW_INDEX_SCAN" not in q.explain()  # index is l2sq

    def test_cosine_similarity_expr_rewrite(self):
        """(1 - cos_sim) -> cos_distance -> cosine index scan
        (hnsw_optimize_expr.cpp + hnsw_metrics.test analog)."""
        rng = np.random.default_rng(0)
        vecs = rng.standard_normal((500, 8)).astype(np.float32)
        db = Database(device=CPU)
        db.create_table("t", {"id": np.arange(500), "vec": vecs})
        db.create_hnsw_index("cos_idx", "t", "vec", metric="cosine")
        target = rng.standard_normal(8).astype(np.float32)
        order = BinOp(
            "-", const(1.0), fn("array_cosine_similarity", col("vec"), const(target))
        )
        q = db.query("t").order_by(order).limit(5).select("id")
        assert "HNSW_INDEX_SCAN" in q.explain()
        res = q.execute()
        ref = q.execute_unoptimized()
        assert set(res["id"]) == set(ref["id"])

    def test_filter_pullup(self, db):
        """Filters below the TopN are applied after the index scan
        (where_clause_segfault.test analog: may yield < k rows)."""
        q = (
            db.query("items")
            .filter(BinOp(">", col("id"), const(100)))
            .order_by(dist_q([5, 5, 5]))
            .limit(3)
            .select("id")
        )
        plan = q.explain()
        assert "HNSW_INDEX_SCAN" in plan
        assert plan.index("FILTER") < plan.index("HNSW_INDEX_SCAN")
        res = q.execute()
        assert all(res["id"] > 100)

    def test_min_by_rewrite(self, db):
        q = db.query("items").min_by(col("id"), dist_q([5, 5, 5]), 3)
        assert "HNSW_INDEX_SCAN" in q.explain()
        res = q.execute()
        ids = res["min_by"][0]
        assert ids[0] == 5 * 81 + 5 * 9 + 5
        assert len(ids) == 3

    def test_knn_join_rewrite_and_parity(self, db, rng):
        queries = rng.uniform(0, 8, (10, 3)).astype(np.float32)
        db.create_table("queries", {"qid": np.arange(10), "qvec": queries})
        q = (
            db.query("queries")
            .knn_join("items", "vec", col("qvec"), k=3)
        )
        plan = q.explain()
        assert "HNSW_INDEX_JOIN" in plan
        res = q.execute()
        assert len(res["l_qid"]) == 30
        assert res["row_number"].max() == 3
        # parity vs brute-force fallback: compare per-rank distances, not ids —
        # the integer grid is full of exact ties, where any equidistant
        # neighbor is a correct answer (the reference's own tests avoid exact
        # row assertions for the same reason, SURVEY §4)
        ref = q.execute_unoptimized()

        def dists(r):
            d = r["r_vec"].astype(np.float64) - queries[r["l_qid"]].astype(np.float64)
            return np.sqrt((d * d).sum(-1))

        q2 = (
            db.query("queries")
            .knn_join("items", "vec", col("qvec"), k=3)
            .select("l_qid", "r_id", "r_vec", "row_number")
        )
        res = db.execute(q2.plan())
        ref = db.execute_unoptimized(q2.plan())
        np.testing.assert_allclose(dists(res), dists(ref), atol=1e-5)

    def test_vss_macros(self, db, rng):
        queries = rng.uniform(0, 8, (5, 3)).astype(np.float32)
        db.create_table("queries", {"qid": np.arange(5), "qvec": queries})
        res = vss_join(db, "queries", "items", "qvec", "vec", k=2)
        assert len(res["left_qid"]) == 10
        assert np.all(np.diff(res["score"].reshape(5, 2), axis=1) >= 0)
        m = vss_match(db, "items", queries[0], "vec", k=4)
        assert len(m["id"]) == 4

    def test_dml_maintains_index(self, db):
        new_ids = db.insert("items", {"id": [10000], "vec": [[20.0, 20.0, 20.0]]})
        q = db.query("items").order_by(dist_q([20, 20, 20])).limit(1).select("id")
        assert "HNSW_INDEX_SCAN" in q.explain()
        assert q.execute()["id"][0] == 10000
        db.delete("items", new_ids)
        assert q.execute()["id"][0] != 10000
        # update = delete + insert
        target = 5 * 81 + 5 * 9 + 5
        rid = db.table("items").rowids[target]
        db.update("items", [rid], {"vec": np.asarray([[30.0, 30.0, 30.0]], np.float32)})
        r = db.query("items").order_by(dist_q([30, 30, 30])).limit(1).select("id").execute()
        # the id column keeps its original value through the delete+insert
        assert r["id"][0] == target

    def test_option_binder_errors(self):
        db = Database(device=CPU)
        db.create_table("t", {"vec": np.ones((10, 4), np.float32)})
        cases = [
            (dict(metric="invalid"), "HNSW index 'metric' must be one of: 'l2sq', 'cosine', 'ip'"),
            (dict(ef_construction="x"), "HNSW index 'ef_construction' must be an integer"),
            (dict(ef_construction=0), "HNSW index 'ef_construction' must be at least 1"),
            (dict(ef_search="x"), "HNSW index 'ef_search' must be an integer"),
            (dict(ef_search=-1), "HNSW index 'ef_search' must be at least 1"),
            (dict(m="x"), "HNSW index 'M' must be an integer"),
            (dict(m=1), "HNSW index 'M' must be at least 2"),
            (dict(m0="x"), "HNSW index 'M0' must be an integer"),
            (dict(m0=1), "HNSW index 'M0' must be at least 2"),
        ]
        for kwargs, msg in cases:
            with pytest.raises(BinderError) as e:
                db.create_hnsw_index("i", "t", "vec", **kwargs)
            assert msg in str(e.value), (kwargs, str(e.value))
        with pytest.raises(BinderError, match="FLOAT"):
            db.create_table("s", {"x": np.arange(10)})
            db.create_hnsw_index("i", "s", "x")

    def test_persistence_gate(self, tmp_path):
        db = Database(path=str(tmp_path / "db"), device=CPU)
        db.create_table("t", {"vec": np.ones((10, 4), np.float32)})
        with pytest.raises(BinderError, match="hnsw_enable_experimental_persistence"):
            db.create_hnsw_index("i", "t", "vec")
        db.set_setting("hnsw_enable_experimental_persistence", True)
        db.create_hnsw_index("i", "t", "vec")

    def test_ef_search_setting(self, db):
        db.set_setting("hnsw_ef_search", 256)
        q = db.query("items").order_by(dist_q([5, 5, 5])).limit(3).select("id")
        res = q.execute()
        assert res["id"][0] == 5 * 81 + 5 * 9 + 5
        with pytest.raises(BinderError):
            db.set_setting("nonexistent", 1)

    def test_index_info_pragma(self, db):
        info = db.hnsw_index_info()
        assert len(info) == 1
        assert info[0]["index_name"] == "my_idx"
        assert info[0]["count"] == 729
        assert info[0]["metric"] == "l2sq"

    def test_compact_pragma(self, db):
        db.delete("items", list(range(50)))
        db.hnsw_compact_index("my_idx")
        e = db.indexes["my_idx"]
        assert e.index.deleted_count == 0
        q = db.query("items").order_by(dist_q([5, 5, 5])).limit(3).select("id")
        assert q.execute()["id"][0] == 5 * 81 + 5 * 9 + 5
        with pytest.raises(BinderError, match="does not exist"):
            db.hnsw_compact_index("nope")

    def test_database_checkpoint_roundtrip(self, db, tmp_path):
        db.set_setting("hnsw_enable_experimental_persistence", True)
        path = str(tmp_path / "ckpt")
        db.checkpoint(path)
        db2 = Database.open(path, device=CPU)
        assert "my_idx" in db2.indexes
        q = db2.query("items").order_by(dist_q([5, 5, 5])).limit(3).select("id")
        assert "HNSW_INDEX_SCAN" in q.explain()
        assert q.execute()["id"][0] == 5 * 81 + 5 * 9 + 5

    def test_explain_analyze(self, db):
        q = db.query("items").order_by(dist_q([5, 5, 5])).limit(3).select("id")
        report, result = db.explain_analyze(q.plan())
        assert "HNSW_INDEX_SCAN" in report
        assert "ms," in report and "rows]" in report
        assert result["id"][0] == 5 * 81 + 5 * 9 + 5
        # SQL surface
        r = db.sql(
            "EXPLAIN ANALYZE SELECT id FROM items "
            "ORDER BY array_distance(vec, [5.0,5.0,5.0]) LIMIT 3"
        )
        assert "HNSW_INDEX_SCAN" in r["explain"][0]

    def test_search_stats(self, db):
        from vss_tpu_torch.index.search import hnsw_search

        e = db.indexes["my_idx"]
        d, i, stats = hnsw_search(
            e.index.graph, e.index.config, torch.tensor([[5.0, 5.0, 5.0]]), k=3,
            with_stats=True,
        )
        assert stats["iterations"] > 0
        assert stats["distance_evals"] > 0

    def test_filter_pushdown_setting(self, db):
        """With hnsw_pushdown_filters on, the scan returns k rows that all
        match the predicate (unlike the reference's post-filter)."""
        db.set_setting("hnsw_pushdown_filters", True)
        q = (
            db.query("items")
            .filter(BinOp(">", col("id"), const(700)))
            .order_by(dist_q([5, 5, 5]))
            .limit(3)
            .select("id")
        )
        plan = q.explain()
        assert "filtered" in plan
        res = q.execute()
        assert len(res["id"]) == 3          # full k despite the selective filter
        assert all(res["id"] > 700)
        # parity: must equal exact filtered brute force
        ref = q.execute_unoptimized()
        assert set(res["id"]) == set(ref["id"])

    def test_metric_routing_multiple_indexes(self, rng):
        """hnsw_metrics.test analog: one index per metric on the same column;
        each distance function must route to the matching index."""
        vecs = rng.standard_normal((300, 8)).astype(np.float32)
        db = Database(device=CPU)
        db.create_table("t", {"id": np.arange(300), "vec": vecs})
        db.create_hnsw_index("idx_l2", "t", "vec", metric="l2sq")
        db.create_hnsw_index("idx_cos", "t", "vec", metric="cosine")
        db.create_hnsw_index("idx_ip", "t", "vec", metric="ip")
        target = const(rng.standard_normal(8).astype(np.float32))
        cases = [
            ("array_distance", "idx_l2"),
            ("array_cosine_distance", "idx_cos"),
            ("array_negative_inner_product", "idx_ip"),
        ]
        for fname, idx_name in cases:
            q = db.query("t").order_by(fn(fname, col("vec"), target)).limit(3).select("id")
            plan = q.explain()
            assert idx_name in plan, (fname, plan)
        # similarity (not a distance) must NOT be rewritten
        q = db.query("t").order_by(
            fn("array_cosine_similarity", col("vec"), target)
        ).limit(3).select("id")
        assert "HNSW_INDEX_SCAN" not in q.explain()

    def test_knn_join_with_null_vectors(self, db, rng):
        """hnsw_lateral_join.test 'with nulls' analog: NULL outer vectors
        produce no matches; NULL inner rows are never matched."""
        queries = rng.uniform(0, 8, (4, 3)).astype(np.float32)
        db.create_table("queries", {"qid": np.arange(4), "qvec": queries})
        # NULL an outer row
        db.table("queries").columns["qvec"][2] = np.nan
        db.table("queries")._bump()
        q = db.query("queries").knn_join("items", "vec", col("qvec"), k=2)
        res = q.execute()
        assert 2 not in set(res["l_qid"].tolist())      # null outer -> no rows
        assert len(res["l_qid"]) == 6                   # 3 live outers x 2
        # same through the brute-force fallback
        ref = q.execute_unoptimized()
        assert 2 not in set(ref["l_qid"].tolist())
        assert len(ref["l_qid"]) == 6


class TestPushdown:
    """Ports `tests/test_pushdown.py`."""

    @pytest.fixture
    def db(self, rng):
        d = Database(device=CPU)
        d.sql("CREATE TABLE t (id BIGINT, name VARCHAR, vec FLOAT[4], extra FLOAT)")
        n = 300
        d.insert(
            "t",
            {
                "id": np.arange(n),
                "name": np.asarray([f"row{i}" for i in range(n)], object),
                "vec": rng.standard_normal((n, 4)).astype(np.float32),
                "extra": rng.standard_normal(n),
            },
        )
        return d

    def test_projection_pushdown_plan_and_result(self, db):
        """The analog of hnsw_projection.test: an index scan under a narrow
        projection fetches only the referenced columns."""
        db.sql("CREATE INDEX i ON t USING HNSW (vec)")
        q = "SELECT id FROM t ORDER BY array_distance(vec, [0.0,0.0,0.0,0.0]) LIMIT 3"
        plan = db.sql("EXPLAIN " + q)["explain"][0]
        assert "HNSW_INDEX_SCAN" in plan and "cols=[id]" in plan
        r = db.sql(q)
        assert len(r["id"]) == 3
        # projecting an expression over two columns pulls exactly those
        q2 = (
            "SELECT id, array_distance(vec, [0.0,0.0,0.0,0.0]) AS d FROM t "
            "ORDER BY array_distance(vec, [0.0,0.0,0.0,0.0]) LIMIT 3"
        )
        plan2 = db.sql("EXPLAIN " + q2)["explain"][0]
        assert "cols=[id, vec]" in plan2
        r2 = db.sql(q2)
        assert np.all(np.diff(r2["d"]) >= 0)
        assert r2["id"].tolist() == r["id"].tolist()

    def test_projection_pushdown_brute_force(self, db):
        q = "SELECT name FROM t ORDER BY array_distance(vec, [0.0,0.0,0.0,0.0]) LIMIT 2"
        plan = db.sql("EXPLAIN " + q)["explain"][0]
        assert "BRUTE_FORCE_TOPK" in plan and "cols=[name]" in plan
        r = db.sql(q)
        assert len(r["name"]) == 2

    def test_pushed_filter_mask_vectorized(self, db):
        """Filtered search: the slot mask is built vectorized; the scan
        returns k rows all satisfying the predicate."""
        db.sql("CREATE INDEX i ON t USING HNSW (vec)")
        db.set_setting("hnsw_pushdown_filters", True)
        q = (
            "SELECT id FROM t WHERE id >= 250 "
            "ORDER BY array_distance(vec, [0.0,0.0,0.0,0.0]) LIMIT 5"
        )
        plan = db.sql("EXPLAIN " + q)["explain"][0]
        assert "filtered" in plan
        r = db.sql(q)
        assert len(r["id"]) == 5
        assert all(i >= 250 for i in r["id"])

    def test_pushed_filter_mask_is_cached_device_resident(self, db, monkeypatch):
        """Repeat filtered queries must NOT redo the host pass (predicate
        eval + isin over the slot tape): the device mask is cached per
        (predicate, table version, graph version) and only invalidated by
        DML. Mirrors index_dense.hpp:1816-1828 applying the predicate inside
        the search with zero per-query host work."""
        import vss_tpu_torch.query.exec as ex

        db.sql("CREATE INDEX i ON t USING HNSW (vec)")
        db.set_setting("hnsw_pushdown_filters", True)
        q = (
            "SELECT id FROM t WHERE id >= 250 "
            "ORDER BY array_distance(vec, [0.0,0.0,0.0,0.0]) LIMIT 5"
        )
        calls = {"n": 0}
        real_isin = ex.np.isin

        def counting_isin(*a, **kw):
            calls["n"] += 1
            return real_isin(*a, **kw)

        monkeypatch.setattr(ex.np, "isin", counting_isin)
        r1 = db.sql(q)
        assert calls["n"] == 1
        r2 = db.sql(q)
        r3 = db.sql(q)
        assert calls["n"] == 1, "repeat filtered search redid the host pass"
        assert r1["id"].tolist() == r2["id"].tolist() == r3["id"].tolist()
        # a different predicate builds (and caches) its own mask
        q2 = q.replace("id >= 250", "id >= 100")
        db.sql(q2)
        db.sql(q2)
        assert calls["n"] == 2
        # DML invalidates: the next filtered search rebuilds the mask once
        db.sql("INSERT INTO t VALUES (999, 'x', [0.0,0.0,0.0,0.0], 0.0)")
        r4 = db.sql(q)
        assert calls["n"] == 3
        assert all(i >= 250 for i in r4["id"])

    def test_macro_score_follows_reference_semantics(self, rng):
        """vss_join/vss_match score: euclidean ascending for l2sq (min_by),
        similarity descending for cosine/ip (max_by) — the reference macros'
        CASE (hnsw_index_macros.cpp:24-25,55-56)."""
        db = Database(device=CPU)
        g = rng.standard_normal((50, 4)).astype(np.float32)
        q = rng.standard_normal((5, 4)).astype(np.float32)
        db.create_table("items", {"id": np.arange(50), "vec": g})
        db.create_table("queries", {"qid": np.arange(5), "qvec": q})

        r = vss_join(db, "queries", "items", "qvec", "vec", k=3, metric="l2sq")
        s = r["score"].reshape(5, 3)
        assert np.all(np.diff(s, axis=1) >= 0)  # ascending distance
        # score IS the euclidean distance
        d0 = np.linalg.norm(q[0] - g[int(r["right_id"][0])])
        assert abs(s[0, 0] - d0) < 1e-3

        r = vss_join(db, "queries", "items", "qvec", "vec", k=3, metric="cosine")
        s = r["score"].reshape(5, 3)
        assert np.all(np.diff(s, axis=1) <= 1e-6)  # descending similarity
        cos = float(
            np.dot(q[0], g[int(r["right_id"][0])])
            / (np.linalg.norm(q[0]) * np.linalg.norm(g[int(r["right_id"][0])]))
        )
        assert abs(s[0, 0] - cos) < 1e-3

        r = vss_match(db, "items", q[0], "vec", k=3, metric="ip")
        assert np.all(np.diff(r["score"]) <= 1e-6)  # descending inner product
        assert abs(r["score"][0] - float(np.dot(q[0], g[int(r['id'][0])]))) < 1e-3


class TestConcurrency:
    """Ports `tests/test_concurrency.py`."""

    def test_search_during_insert_stress(self, rng):
        """Concurrent searches while a writer inserts: no exceptions, every
        result is a valid row, and queries never serialize on the DML lock."""
        db = Database(device=CPU)
        db.sql("CREATE TABLE items (id BIGINT, vec FLOAT[8])")
        base = rng.standard_normal((500, 8)).astype(np.float32)
        db.insert("items", {"id": np.arange(500), "vec": base})
        db.create_hnsw_index("idx", "items", "vec", wave_size=128)

        stop = threading.Event()
        errors: list = []

        def writer():
            try:
                i = 0
                while not stop.is_set() and i < 40:
                    vec = rng.standard_normal((4, 8)).astype(np.float32)
                    db.insert(
                        "items",
                        {"id": np.arange(1000 + 4 * i, 1004 + 4 * i), "vec": vec},
                    )
                    i += 1
            except Exception as e:  # pragma: no cover
                errors.append(e)

        def reader():
            try:
                q = rng.standard_normal((4, 8)).astype(np.float32)
                for _ in range(25):
                    r = db.sql(
                        "SELECT id FROM items ORDER BY "
                        f"array_distance(vec, {list(map(float, q[0]))}) LIMIT 5"
                    )
                    assert len(r["id"]) == 5
                    assert all(i >= 0 for i in r["id"])
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=writer)] + [
            threading.Thread(target=reader) for _ in range(3)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stop.set()
        assert not errors, errors
        # final state consistent
        r = db.sql("SELECT count(*) FROM items")
        assert r["count"][0] == 500 + 40 * 4

    def test_lazy_index_load(self, tmp_path, rng):
        """Database.open must not deserialize indexes until first use; queries
        trigger the load transparently; checkpointing a clean unloaded index
        re-uses the existing stream."""
        db = Database(device=CPU)
        db.sql("CREATE TABLE t (id BIGINT, vec FLOAT[4])")
        db.insert(
            "t",
            {"id": np.arange(200), "vec": rng.standard_normal((200, 4)).astype(np.float32)},
        )
        db.sql("SET hnsw_enable_experimental_persistence = TRUE")
        db.create_hnsw_index("idx", "t", "vec")
        want = db.sql(
            "SELECT id FROM t ORDER BY array_distance(vec, [0.1, 0.2, 0.3, 0.4]) LIMIT 3"
        )["id"].tolist()

        for path in (str(tmp_path / "d1"), str(tmp_path / "d2.vssdb")):
            try:
                db.checkpoint(path)
            except IOError:
                pytest.skip("blockstore unavailable")
            db2 = Database.open(path, device=CPU)
            entry = db2.indexes["idx"]
            assert not entry.loaded, "open() must defer index deserialization"
            got = db2.sql(
                "SELECT id FROM t ORDER BY array_distance(vec, [0.1, 0.2, 0.3, 0.4]) LIMIT 3"
            )["id"].tolist()
            assert entry.loaded
            assert got == want
            # re-checkpoint with the index still unloaded elsewhere: a fresh
            # open + checkpoint of the same path must not need the index
            db3 = Database.open(path, device=CPU)
            db3.checkpoint(path)
            assert not db3.indexes["idx"].loaded
            db4 = Database.open(path, device=CPU)
            got = db4.sql(
                "SELECT id FROM t ORDER BY array_distance(vec, [0.1, 0.2, 0.3, 0.4]) LIMIT 3"
            )["id"].tolist()
            assert got == want

    def test_lazy_index_dml_triggers_load(self, tmp_path, rng):
        db = Database(device=CPU)
        db.sql("CREATE TABLE t (id BIGINT, vec FLOAT[4])")
        db.insert(
            "t",
            {"id": np.arange(50), "vec": rng.standard_normal((50, 4)).astype(np.float32)},
        )
        db.sql("SET hnsw_enable_experimental_persistence = TRUE")
        db.create_hnsw_index("idx", "t", "vec")
        path = str(tmp_path / "d")
        db.checkpoint(path)
        db2 = Database.open(path, device=CPU)
        assert not db2.indexes["idx"].loaded
        db2.insert("t", {"id": [999], "vec": [[9.0, 9.0, 9.0, 9.0]]})
        assert db2.indexes["idx"].loaded  # DML maintains the index
        r = db2.sql(
            "SELECT id FROM t ORDER BY array_distance(vec, [9.0, 9.0, 9.0, 9.0]) LIMIT 1"
        )
        assert r["id"][0] == 999


class TestCostModel:
    """Ports `tests/test_cost_model.py`."""

    @pytest.fixture
    def db(self):
        d = Database(device=CPU)
        d.create_table("items", {"id": np.arange(729, dtype=np.int64), "vec": grid_729()})
        d.create_hnsw_index("my_idx", "items", "vec", metric="l2sq", seed=0)
        d.create_table(
            "queries", {"qid": np.arange(8, dtype=np.int64), "vec": grid_729()[:8]}
        )
        return d

    def test_model_matches_flagship_measurements(self):
        """The port's rates (measured on an H100) must reproduce what the
        card measured: at 1M x 128 the graph wins single queries, and tiny
        corpora prefer exact. The JAX package's TPU fits also had the f32
        exact scan win 512-query batches at 1M; on the H100 the two
        estimates came within 7% of each other with one card run's rates
        and 2x apart with another's, and the card's oracle (K3, 5.5 ms a
        batch) lost to the int8 graph (2.2 ms) there, so this test pins no
        choice at that point."""
        assert not prefer_exact(1_000_000, 128, 4, n_queries=1, ef=64, m0=32)
        assert prefer_exact(729, 3, 4, n_queries=1, ef=64, m0=32)
        assert prefer_exact(729, 3, 4, n_queries=512, ef=64, m0=32)

    def test_tape_scan_crossover_at_flagship_scale(self):
        """Storage-native int8 tape scan (EXACT_SCAN_TOPK pricing) at the
        flagship point (1M x 128 int8, ef=64, m0=32). On the TPU the scan
        won 512-query batches; on the H100 the graph wins them too, as the
        card measured (`chip_smoke.py`: `search` 2.2 ms against
        `scan_search` 3.9 ms a batch of 512), and the model says so. On a
        65,536-row tape the scan wins a 2,048-query batch (the corpus on
        which `chip_smoke.py` runs EXACT_SCAN_JOIN)."""
        from vss_tpu_torch.query.cost import serving_path

        assert not prefer_exact(
            1_000_000, 128, 1, n_queries=1, ef=64, m0=32, tape_scan=True
        )
        assert not prefer_exact(
            1_000_000, 128, 1, n_queries=512, ef=64, m0=32, tape_scan=True
        )
        assert serving_path(1_000_000, 128, 1, 512, 64, 32) == "graph"
        assert serving_path(1_000_000, 128, 1, 1, 64, 32) == "graph"
        assert serving_path(65_536, 128, 1, 2048, 64, 32) == "scan"

    def test_topn_flips_to_exact_on_tiny_corpus(self, db):
        q = db.query("items").order_by(dist_q([5, 5, 5])).limit(3).select("id")
        assert "HNSW_INDEX_SCAN" in q.explain()  # default: reference parity
        db.set_setting("hnsw_cost_model", True)
        plan = q.explain()
        # the index's own tape serves the exact path (EXACT_SCAN_TOPK)
        assert "EXACT_SCAN_TOPK" in plan and "HNSW_INDEX_SCAN" not in plan
        assert "index=my_idx" in plan
        res = q.execute()
        assert res["id"][0] == 5 * 81 + 5 * 9 + 5

    def test_exact_scan_with_filter_is_exact_filtered_topk(self, db):
        """Pushed filters mask slots BEFORE top-k on the scan path: k
        applies to the filtered set (better than the graph's post-filter,
        which can come home short)."""
        db.set_setting("hnsw_cost_model", True)
        q = (
            db.query("items")
            .filter(BinOp("<", col("id"), const(100)))
            .order_by(dist_q([5, 5, 5]))
            .limit(5)
            .select("id")
        )
        plan = q.explain()
        assert "EXACT_SCAN_TOPK" in plan and "filter=" in plan
        res = q.execute()
        assert len(res["id"]) == 5  # k survives the filter
        assert all(v < 100 for v in res["id"])
        # parity with the unfiltered brute-force oracle restricted to id<100
        from vss_tpu_torch.ops import bruteforce_topk

        vecs = grid_729()[:100]
        _, ids = bruteforce_topk(
            torch.tensor([[5.0, 5.0, 5.0]]), torch.from_numpy(vecs), 5, "l2sq",
            device=CPU,
        )
        assert set(np.asarray(res["id"]).tolist()) == set(
            np.asarray(ids)[0].tolist()
        )

    def test_join_flips_to_exact_and_results_match(self, db):
        q = (
            db.query("queries")
            .knn_join("items", "vec", col("vec"), 3)
            .select("row_number", qid=col("l_qid"), rid=col("r_id"))
        )
        assert "HNSW_INDEX_JOIN" in q.explain()
        indexed = q.execute()
        db.set_setting("hnsw_cost_model", True)
        assert "HNSW_INDEX_JOIN" not in q.explain()
        exact = q.execute()
        # exact results are a valid (>=) answer: same ids for a grid with
        # unique distances per query point
        np.testing.assert_array_equal(indexed["qid"], exact["qid"])
        np.testing.assert_array_equal(indexed["rid"][::3], exact["rid"][::3])

    def test_sql_surface(self, db):
        db.sql("SET hnsw_cost_model = true")
        out = db.sql("EXPLAIN SELECT id FROM items ORDER BY array_distance(vec, [5.0, 5.0, 5.0]) LIMIT 3")
        text = str(out)
        assert "EXACT_SCAN_TOPK" in text

    def test_exact_scan_without_index_uses_table_column(self, db):
        """No index on the column -> the table-column BRUTE_FORCE_TOPK form
        (the fallback operator keeps its old label)."""
        db.create_table(
            "bare", {"id": np.arange(729, dtype=np.int64), "vec": grid_729()}
        )
        db.set_setting("hnsw_cost_model", True)
        q = db.query("bare").order_by(dist_q([5, 5, 5])).limit(3).select("id")
        plan = q.explain()
        assert "BRUTE_FORCE_TOPK" in plan and "EXACT_SCAN_TOPK" not in plan
        assert q.execute()["id"][0] == 5 * 81 + 5 * 9 + 5

    def test_calibration_file_roundtrip_and_decisions(self, tmp_path, monkeypatch):
        """The rate constants load from a calibration file for this
        machine's device (keyed by the torch device name, under the port's
        own cache directory) when one exists. With rates 20% off the
        shipped ones injected, the serving-path decisions on the flagship /
        iid / gist shapes are unchanged."""
        import json

        from vss_tpu_torch.query import cost

        monkeypatch.setenv("VSS_COST_CACHE_DIR", str(tmp_path))
        cost._LOADED = None
        try:
            # shipped decisions: flagship 1M x 128 int8, batch 512 and a
            # single query -> graph (both measured winners on the H100)
            shapes = [
                (1_000_000, 128, 1, 512, 64, 32),
                (1_000_000, 128, 1, 1, 64, 32),
                (300_000, 960, 1, 512, 64, 32),
            ]
            baseline = [cost.serving_path(*s) for s in shapes]
            assert baseline[:2] == ["graph", "graph"]

            # a plausible same-chip calibration must not flip any decision
            p = tmp_path / f"cost_{cost._device_key()}.json"
            assert os.path.basename(os.path.dirname(cost._cache_path())) == tmp_path.name
            with open(p, "w") as f:
                json.dump(
                    {
                        "stream_bw": cost.STREAM_BW * 0.8,
                        "random_bw": cost.RANDOM_BW * 1.2,
                        "tape_bw": {"1": cost.TAPE_BW[1] * 1.2,
                                    "2": cost.TAPE_BW[2] * 0.8,
                                    "4": cost.STREAM_BW * 0.8},
                    },
                    f,
                )
            cost._LOADED = None
            r = cost._rates()
            assert r["tape_bw"][1] == cost.TAPE_BW[1] * 1.2  # string keys -> int
            assert [cost.serving_path(*s) for s in shapes] == baseline

            # corrupt file falls back to shipped fits, never raises
            with open(p, "w") as f:
                f.write("{bad json")
            cost._LOADED = None
            assert cost._rates()["tape_bw"][1] == cost.TAPE_BW[1]
        finally:
            cost._LOADED = None

    def test_calibrate_probe_runs_on_cpu(self, tmp_path, monkeypatch):
        """calibrate() measures real rates and persists them (CPU rates are
        meaningless for the H100's decision but the machinery must work
        everywhere; a small probe keeps it short)."""
        from vss_tpu_torch.query import cost

        monkeypatch.setenv("VSS_COST_CACHE_DIR", str(tmp_path))
        cost._LOADED = None
        try:
            out = cost.calibrate(n_rows=1 << 11, device=CPU)
            assert out["stream_bw"] > 0
            assert out["random_bw"] > 0
            assert out["gather_bw"] > 0
            assert set(out["tape_bw"]) == {1, 2, 4}
            assert out["path"] == str(tmp_path / "cost_cpu.json")
            assert (tmp_path / "cost_cpu.json").exists()
            # the persisted probe is now the active rate set
            assert cost._rates()["stream_bw"] == out["stream_bw"]
        finally:
            cost._LOADED = None


class TestNativeDatabase:
    """Ports `tests/test_native.py`'s two Database tests."""

    def test_database_vssdb_single_file(self, tmp_path, rng):
        """End-to-end single-file checkpoint through the block store."""
        from vss_tpu_torch.storage.blockfile import blockstore_available

        if not blockstore_available():
            pytest.skip("no C++ toolchain")
        db = Database(device=CPU)
        vecs = rng.standard_normal((300, 8)).astype(np.float32)
        db.create_table("t", {"id": np.arange(300), "vec": vecs})
        db.set_setting("hnsw_enable_experimental_persistence", True)
        db.create_hnsw_index("i", "t", "vec")
        p = str(tmp_path / "db.vssdb")
        db.checkpoint(p)
        db2 = Database.open(p, device=CPU)
        assert db2.table("t").num_rows == 300
        from vss_tpu_torch.query import col, const, fn

        q = (
            db2.query("t")
            .order_by(fn("array_distance", col("vec"), const(vecs[5])))
            .limit(1)
            .select("id")
        )
        assert "HNSW_INDEX_SCAN" in q.explain()
        assert q.execute()["id"][0] == 5
        # re-checkpoint into the same file (dirty tracking + block reuse)
        db2.insert("t", {"id": [999], "vec": vecs[:1] + 5.0})
        db2.checkpoint(p)
        db3 = Database.open(p, device=CPU)
        assert db3.table("t").num_rows == 301

    def test_db_index_drop_recreate_reclaims_blocks(self, tmp_path, rng):
        """hnsw_reclaim_storage.test_slow analog at the database level: drop +
        recreate + checkpoint loops must not grow the single-file store."""
        from vss_tpu_torch.storage.blockfile import BlockStore, blockstore_available

        if not blockstore_available():
            pytest.skip("no C++ toolchain")
        vecs = rng.standard_normal((500, 16)).astype(np.float32)
        db = Database(device=CPU)
        db.create_table("t", {"id": np.arange(500), "vec": vecs})
        db.set_setting("hnsw_enable_experimental_persistence", True)
        db.create_hnsw_index("i", "t", "vec")
        p = str(tmp_path / "reclaim.vssdb")
        db.checkpoint(p)
        baseline = os.path.getsize(p)
        for _ in range(4):
            db.drop_index("i")
            db.create_hnsw_index("i", "t", "vec")
            db.checkpoint(p)
        grown = os.path.getsize(p)
        assert grown <= baseline * 1.3, (baseline, grown)
        with BlockStore(p) as bs:
            assert bs.free_blocks >= 0  # store remains consistent
        db2 = Database.open(p, device=CPU)
        d, rows = db2.indexes["i"].index.search(vecs[:3], k=1)
        assert np.asarray(rows)[:, 0].tolist() == [0, 1, 2]


class TestPortSpecifics:
    """What the port adds or changes around the JAX package's query layer."""

    def test_database_runs_on_cuda_unless_asked(self):
        if torch.cuda.is_available():
            assert Database().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                Database()
        assert Database(device=CPU).device.type == "cpu"

    def test_sharded_indexes_are_not_ported_yet(self, tmp_path):
        """Kept under its first name: sharded indexes, once refused here
        with NotImplementedError, now build on the database's default
        mesh (one slot on the CPU); a directory checkpoint marks them
        `sharded` in its catalog and opens them back, and a catalog that
        names a sharded index whose shards are missing fails to open."""
        import json
        import shutil

        from vss_tpu_torch.parallel import ShardedHNSWIndex

        db = Database(device=CPU)
        db.create_table("t", {"id": np.arange(20), "vec": grid_729()[:20]})
        entry = db.create_hnsw_index("i", "t", "vec", sharded=True)
        assert isinstance(entry.index, ShardedHNSWIndex) and entry.index.n_shards == 1
        path = str(tmp_path / "d")
        db.checkpoint(path)
        with open(os.path.join(path, "catalog.json")) as f:
            catalog = json.load(f)
        assert catalog["indexes"]["i"]["sharded"] is True
        back = Database.open(path, device=CPU).indexes["i"].index
        assert isinstance(back, ShardedHNSWIndex) and back.count == 20
        shutil.rmtree(os.path.join(path, "index_i.sharded"))
        with pytest.raises(FileNotFoundError):
            Database.open(path, device=CPU)

    def test_results_come_back_through_host(self, monkeypatch):
        """Every device result the executor reads goes through
        `table.host` (`.cpu().numpy()`): with `np.asarray` of a tensor
        made to fail, as it does for a CUDA tensor, every operator still
        runs."""
        import vss_tpu_torch.query.exec as ex
        import vss_tpu_torch.query.macros as mc

        db = Database(device=CPU)
        db.create_table("items", {"id": np.arange(729), "vec": grid_729()})
        db.create_table("bare", {"id": np.arange(729), "vec": grid_729()})
        db.create_table("queries", {"qid": np.arange(4), "qvec": grid_729()[100:104]})
        db.create_hnsw_index("i", "items", "vec")
        real = np.asarray

        def strict(a, *args, **kw):
            if isinstance(a, torch.Tensor):
                raise TypeError("np.asarray of a tensor")
            return real(a, *args, **kw)

        for mod in (ex, mc):
            monkeypatch.setattr(mod.np, "asarray", strict)
        q = "[5.0, 5.0, 5.0]::FLOAT[3]"
        want = 5 * 81 + 5 * 9 + 5
        assert db.sql(f"SELECT id FROM items ORDER BY array_distance(vec, {q}) LIMIT 3"
                      )["id"][0] == want
        assert db.sql(f"SELECT id FROM bare ORDER BY array_distance(vec, {q}) LIMIT 3"
                      )["id"][0] == want
        assert db.sql(f"SELECT id FROM items WHERE id > 5 ORDER BY "
                      f"array_distance(vec, {q}) LIMIT 3")["id"][0] == want
        for t in ("items", "bare"):
            r = db.sql(f"SELECT l_qid, r_id FROM knn_join(queries, {t}, qvec, vec, 2)")
            assert r["r_id"][::2].tolist() == list(range(100, 104))
        r = db.sql("SELECT qid, id FROM queries, LATERAL (SELECT id FROM items ORDER BY "
                   "array_distance(queries.qvec, items.vec) LIMIT 1)")
        assert r["id"].tolist() == list(range(100, 104))
        assert len(db.sql("SELECT * FROM vss_join(queries, bare, qvec, vec, 2)")["score"]) == 8
        assert vss_match(db, "bare", grid_729()[7], "vec", k=1)["id"][0] == 7
        db.set_setting("hnsw_cost_model", True)
        assert db.sql(f"SELECT id FROM items ORDER BY array_distance(vec, {q}) LIMIT 3"
                      )["id"][0] == want
        r = db.sql("SELECT l_qid, r_id FROM knn_join(queries, items, qvec, vec, 2)")
        assert r["r_id"][::2].tolist() == list(range(100, 104))

    def test_modulo_operator(self):
        """`%` takes the dividend's sign (DuckDB's rule); the JAX package's
        parser has no modulo."""
        db = Database(device=CPU)
        db.create_table("t", {"id": np.arange(-6, 7)})
        r = db.sql("SELECT id, id % 5 AS m FROM t WHERE id % 5 = 0")
        assert r["id"].tolist() == [-5, 0, 5]
        r = db.sql("SELECT id % 4 AS m FROM t WHERE id = -6")
        assert r["m"].tolist() == [-2]
        db.sql("DELETE FROM t WHERE id % 2 = 0")
        assert db.sql("SELECT count(*) FROM t")["count"][0] == 6

    def test_cost_cache_is_per_device_name(self, tmp_path, monkeypatch):
        from vss_tpu_torch.query import cost

        monkeypatch.setenv("VSS_COST_CACHE_DIR", str(tmp_path))
        assert cost._cache_path("cpu") == str(tmp_path / "cost_cpu.json")
        monkeypatch.delenv("VSS_COST_CACHE_DIR")
        assert cost._cache_path("cpu").endswith(
            os.path.join(".cache", "vss_tpu_torch", "cost_cpu.json"))
