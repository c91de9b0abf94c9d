"""The SQL front end of vss_tpu_torch on the CPU.

Ports `tests/test_sql.py` (20 tests), `tests/test_lateral.py` (10),
`tests/test_fuzz.py`, `tests/test_misc_api.py::test_sql_table_functions`,
`tests/test_bf16.py`'s `test_bf16_sql_and_persistence`,
`test_bad_storage_option` and `test_int8_sql_option`, and
`tests/test_sharded.py::test_sharded_index_in_database` to the port, each
file as a class of the same tests, on `Database(device="cpu")`.
"""
import numpy as np
import pytest
import torch

from vss_tpu_torch import BinderError, Database
from vss_tpu_torch.index import HNSWConfig
from vss_tpu_torch.index.dense import HNSWIndex

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine; the eager insert waves run
    faster on one intra-op thread per worker (as in test_torch_crud.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


D = 16

# the queries of `tests/test_lateral.py`
Q_BASIC = (
    "select * from a, lateral (select *, a_id as id_dup from b "
    "order by array_distance(a.a_vec, b.b_vec) limit 1)"
)
Q_PROJ = (
    "select * from a, lateral (select array_distance(a.a_vec, b.b_vec) as "
    "dist, *, a_id as id_dup from b order by dist limit 1)"
)
Q_LIMIT2 = (
    "select * from a, lateral (select *, a_id as id_dup from b "
    "order by array_distance(a.a_vec, b.b_vec) limit 2)"
)
Q_TWO_KEYS = (
    "select * from a, lateral (select *, a_id as id_dup from b "
    "order by array_distance(a.a_vec, b.b_vec), b_str DESC limit 2)"
)


def rows(r, cols):
    return sorted(zip(*(r[c].tolist() for c in cols)))


def exact_topk(oracle: dict, q: np.ndarray, k: int):
    if not oracle:
        return []
    ids = np.fromiter(oracle.keys(), np.int64)
    mat = np.stack([oracle[int(i)] for i in ids])
    d = ((mat.astype(np.float64) - q.astype(np.float64)) ** 2).sum(1)
    order = np.lexsort((ids, d))[:k]
    return ids[order].tolist()


class TestSQL:
    """Ports `tests/test_sql.py`."""

    @pytest.fixture
    def db(self):
        d = Database(device=CPU)
        d.sql("CREATE TABLE items (id BIGINT, vec FLOAT[3])")
        # 729-row grid via bulk python insert (SQL VALUES for 729 rows is slow)
        g = np.stack(
            np.meshgrid(np.arange(9), np.arange(9), np.arange(9), indexing="ij"), -1
        ).reshape(-1, 3).astype(np.float32)
        d.insert("items", {"id": np.arange(729), "vec": g})
        return d

    def test_create_index_and_query(self, db):
        db.sql("CREATE INDEX my_idx ON items USING HNSW (vec) WITH (metric = 'l2sq')")
        res = db.sql(
            "SELECT id, array_distance(vec, [5.0, 5.0, 5.0]) AS d FROM items "
            "ORDER BY array_distance(vec, [5.0, 5.0, 5.0]) LIMIT 3"
        )
        np.testing.assert_allclose(sorted(res["d"]), [0.0, 1.0, 1.0], atol=1e-6)
        exp = db.sql(
            "EXPLAIN SELECT id FROM items ORDER BY array_distance(vec, [5.0,5.0,5.0]) LIMIT 3"
        )
        assert "HNSW_INDEX_SCAN" in exp["explain"][0]

    def test_operator_aliases(self, db):
        db.sql("CREATE INDEX my_idx ON items USING HNSW (vec)")
        exp = db.sql("EXPLAIN SELECT id FROM items ORDER BY vec <-> [5.0,5.0,5.0] LIMIT 3")
        assert "HNSW_INDEX_SCAN" in exp["explain"][0]
        res = db.sql("SELECT id FROM items ORDER BY vec <-> [5.0,5.0,5.0] LIMIT 1")
        assert res["id"][0] == 5 * 81 + 5 * 9 + 5

    def test_min_by_sql(self, db):
        db.sql("CREATE INDEX my_idx ON items USING HNSW (vec)")
        exp = db.sql(
            "EXPLAIN SELECT min_by(id, array_distance(vec, [5.0,5.0,5.0]), 3) FROM items"
        )
        assert "HNSW_INDEX_SCAN" in exp["explain"][0]
        res = db.sql(
            "SELECT min_by(id, array_distance(vec, [5.0,5.0,5.0]), 3) FROM items"
        )
        assert list(res["min_by"][0])[0] == 5 * 81 + 5 * 9 + 5

    def test_insert_delete_update_sql(self, db):
        db.sql("CREATE INDEX my_idx ON items USING HNSW (vec)")
        db.sql("INSERT INTO items VALUES (10000, [20.0, 20.0, 20.0])")
        res = db.sql(
            "SELECT id FROM items ORDER BY array_distance(vec, [20.0,20.0,20.0]) LIMIT 1"
        )
        assert res["id"][0] == 10000
        db.sql("DELETE FROM items WHERE id = 10000")
        res = db.sql(
            "SELECT id FROM items ORDER BY array_distance(vec, [20.0,20.0,20.0]) LIMIT 1"
        )
        assert res["id"][0] != 10000
        db.sql("UPDATE items SET vec = [30.0, 30.0, 30.0] WHERE id = 7")
        res = db.sql(
            "SELECT id FROM items ORDER BY array_distance(vec, [30.0,30.0,30.0]) LIMIT 1"
        )
        assert res["id"][0] == 7

    def test_where_filter_sql(self, db):
        db.sql("CREATE INDEX my_idx ON items USING HNSW (vec)")
        res = db.sql(
            "SELECT id FROM items WHERE id > 100 "
            "ORDER BY array_distance(vec, [5.0,5.0,5.0]) LIMIT 3"
        )
        assert all(res["id"] > 100)

    def test_pragma_info_and_compact(self, db):
        db.sql("CREATE INDEX my_idx ON items USING HNSW (vec)")
        info = db.sql("SELECT * FROM pragma_hnsw_index_info()")
        assert info["index_name"][0] == "my_idx"
        assert info["count"][0] == 729
        db.sql("DELETE FROM items WHERE id < 50")
        db.sql("PRAGMA hnsw_compact_index('my_idx')")
        info = db.sql("SELECT * FROM pragma_hnsw_index_info()")
        assert info["count"][0] == 679
        # deleted count lives on the engine-native info dict (the SQL pragma
        # is column-exact with the reference's 11-column schema)
        assert db.hnsw_index_info()[0]["deleted"] == 0

    def test_set_setting_sql(self, db):
        db.sql("SET hnsw_ef_search = 200")
        assert db.settings["hnsw_ef_search"] == 200

    def test_binder_errors_sql(self, db):
        cases = [
            ("CREATE INDEX i ON items USING HNSW (vec) WITH (metric = 'bogus')",
             "HNSW index 'metric' must be one of"),
            ("CREATE INDEX i ON items USING HNSW (vec) WITH (metric = 2)",
             "HNSW index 'metric' must be a string"),
            ("CREATE INDEX i ON items USING HNSW (vec) WITH (ef_construction = 'x')",
             "HNSW index 'ef_construction' must be an integer"),
            ("CREATE INDEX i ON items USING HNSW (vec) WITH (ef_construction = 0)",
             "HNSW index 'ef_construction' must be at least 1"),
            ("CREATE INDEX i ON items USING HNSW (vec) WITH (m = 1)",
             "HNSW index 'M' must be at least 2"),
            ("CREATE INDEX i ON items USING HNSW (vec) WITH (bogus = 1)",
             "Unknown option for HNSW index: 'bogus'"),
            ("CREATE INDEX i ON items USING BTREE (vec)",
             "unknown index type"),
        ]
        for sql, msg in cases:
            with pytest.raises(BinderError) as e:
                db.sql(sql)
            assert msg in str(e.value), (sql, str(e.value))

    def test_drop_sql(self, db):
        db.sql("CREATE INDEX my_idx ON items USING HNSW (vec)")
        db.sql("DROP INDEX my_idx")
        exp = db.sql(
            "EXPLAIN SELECT id FROM items ORDER BY array_distance(vec, [5.0,5.0,5.0]) LIMIT 3"
        )
        assert "HNSW_INDEX_SCAN" not in exp["explain"][0]
        db.sql("DROP TABLE items")
        with pytest.raises(BinderError, match="does not exist"):
            db.sql("SELECT * FROM items")

    def test_select_exprs(self, db):
        res = db.sql("SELECT id, id * 2 AS double_id FROM items WHERE id < 3 ORDER BY id LIMIT 3")
        assert res["double_id"].tolist() == [0, 2, 4]

    def test_checkpoint_sql(self, db, tmp_path):
        db.sql("SET hnsw_enable_experimental_persistence = TRUE")
        db.sql("CREATE INDEX my_idx ON items USING HNSW (vec)")
        db.sql(f"CHECKPOINT '{tmp_path}/db'")
        db2 = Database.open(f"{tmp_path}/db", device=CPU)
        res = db2.sql(
            "SELECT id FROM items ORDER BY array_distance(vec, [5.0,5.0,5.0]) LIMIT 1"
        )
        assert res["id"][0] == 5 * 81 + 5 * 9 + 5

    def test_count_and_aggregates(self, db):
        r = db.sql("SELECT count(*) FROM items")
        assert r["count"][0] == 729
        r = db.sql("SELECT count(*) AS n, min(id) AS lo, max(id) AS hi FROM items WHERE id < 10")
        assert (r["n"][0], r["lo"][0], r["hi"][0]) == (10, 0, 9)
        r = db.sql("SELECT sum(id) FROM items WHERE id < 4")
        assert r["sum"][0] == 6

    def test_null_vectors(self, db):
        """NULL vectors: skipped at index build, skipped on insert, never
        returned by scans (reference IS NOT NULL + Construct-skip semantics)."""
        db.sql("CREATE INDEX my_idx ON items USING HNSW (vec)")
        db.insert("items", {"id": [9001, 9002], "vec": [None, [50.0, 50.0, 50.0]]})
        info = db.sql("SELECT * FROM pragma_hnsw_index_info()")
        assert info["count"][0] == 730  # only the non-null row was indexed
        r = db.sql(
            "SELECT id FROM items ORDER BY array_distance(vec, [50.0,50.0,50.0]) LIMIT 1"
        )
        assert r["id"][0] == 9002
        # brute-force path also excludes the null row
        db2_res = db.sql(
            "SELECT count(*) FROM items WHERE id = 9001"
        )
        assert db2_res["count"][0] == 1  # row exists in the table itself

    def test_sql_null_insert(self, db):
        """INSERT ... VALUES (_, NULL) stores a NULL vector row (regression:
        the SQL layer used to array-ify before NULL mapping)."""
        db.sql("CREATE INDEX my_idx ON items USING HNSW (vec)")
        db.sql("INSERT INTO items VALUES (9000, NULL)")
        assert db.sql("SELECT count(*) FROM items")["count"][0] == 730
        info = db.sql("SELECT * FROM pragma_hnsw_index_info()")
        assert info["count"][0] == 729

    def test_group_by(self, db):
        """GROUP BY over a knn_join result (hnsw_lateral_join_group analog)."""
        r = db.sql("SELECT id FROM items WHERE id < 6 ORDER BY id LIMIT 6")
        # plain group-by on a computed bucket
        db.create_table("labeled", {
            "grp": np.asarray([0, 0, 1, 1, 1, 2]),
            "val": np.asarray([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], np.float32),
        })
        r = db.sql("SELECT grp, count(*) AS n, sum(val) AS s, max(val) AS hi "
                   "FROM labeled GROUP BY grp")
        assert r["grp"].tolist() == [0, 1, 2]
        assert r["n"].tolist() == [2, 3, 1]
        assert r["s"].tolist() == [3.0, 12.0, 6.0]
        assert r["hi"].tolist() == [2.0, 5.0, 6.0]
        # grouped over a knn_join table function: matches per query row
        g2 = np.stack(np.meshgrid(*[np.arange(9)]*3, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
        db.create_table("qs", {"qid": np.arange(3), "qvec": g2[:3] + 0.01})
        r = db.sql("SELECT l_qid, count(*) AS hits FROM knn_join(qs, items, qvec, vec, 4) GROUP BY l_qid")
        assert r["hits"].tolist() == [4, 4, 4]
        # non-aggregate column outside GROUP BY -> binder error
        with pytest.raises(BinderError, match="must appear in GROUP BY"):
            db.sql("SELECT val, count(*) FROM labeled GROUP BY grp")

    def test_multi_statement_sql(self):
        db = Database(device=CPU)
        res = db.sql(
            "CREATE TABLE t (id BIGINT, vec FLOAT[2]); "
            "INSERT INTO t VALUES (1, [1.0, 2.0]), (2, [3.0, 4.0]); "
            "CREATE INDEX i ON t USING HNSW (vec); "
            "SELECT id FROM t ORDER BY vec <-> [2.9, 4.1] LIMIT 1"
        )
        assert res["id"][0] == 2
        # semicolons inside string literals survive
        db.sql("CREATE TABLE s (name VARCHAR)")

    def test_scalar_nulls(self):
        db = Database(device=CPU)
        db.sql("CREATE TABLE p (name VARCHAR, score FLOAT, n BIGINT)")
        db.sql("INSERT INTO p VALUES ('a', 1.5, 1), (NULL, NULL, 2)")
        r = db.sql("SELECT count(*) AS rows, count(name) AS names, count(score) AS scores FROM p")
        assert (r["rows"][0], r["names"][0], r["scores"][0]) == (2, 1, 1)
        with pytest.raises(BinderError, match="integer column"):
            db.sql("INSERT INTO p VALUES ('c', 2.0, NULL)")

    def test_aggregates_skip_nulls(self):
        """SQL semantics: sum/avg/min/max skip NULLs; all-NULL input -> NULL
        (round-1 advisor finding: these previously returned NaN)."""
        db = Database(device=CPU)
        db.sql("CREATE TABLE p (g BIGINT, score FLOAT)")
        db.sql("INSERT INTO p VALUES (0, 1.5), (0, NULL), (0, 2.5), (1, NULL)")
        r = db.sql("SELECT sum(score) AS s, avg(score) AS a, min(score) AS lo, max(score) AS hi FROM p")
        assert r["s"][0] == 4.0
        assert r["a"][0] == 2.0
        assert (r["lo"][0], r["hi"][0]) == (1.5, 2.5)
        # grouped: group 1 is all-NULL -> NULL (NaN-encoded for floats)
        r = db.sql("SELECT g, sum(score) AS s, count(score) AS c FROM p GROUP BY g")
        by_g = {int(g): (s, c) for g, s, c in zip(r["g"], r["s"], r["c"])}
        assert by_g[0] == (4.0, 2)
        assert np.isnan(by_g[1][0]) and by_g[1][1] == 0
        # all-NULL simple aggregate -> NULL
        r = db.sql("SELECT sum(score) AS s FROM p WHERE g = 1")
        assert r["s"][0] is None

    def test_varchar_checkpoint_roundtrip(self, tmp_path):
        """VARCHAR (object) columns round-trip through checkpoints without
        pickling (round-1 advisor finding: np.load refused the pickled file)."""
        db = Database(device=CPU)
        db.sql("CREATE TABLE p (name VARCHAR, score FLOAT)")
        db.sql("INSERT INTO p VALUES ('alpha', 1.0), (NULL, 2.0), ('c', NULL)")
        # directory checkpoint
        db.sql(f"CHECKPOINT '{tmp_path}/dbdir'")
        db2 = Database.open(f"{tmp_path}/dbdir", device=CPU)
        r = db2.sql("SELECT name FROM p")
        assert r["name"].tolist() == ["alpha", None, "c"]
        # single-file block store checkpoint
        from vss_tpu_torch.storage.blockfile import blockstore_available

        if blockstore_available():
            db.sql(f"CHECKPOINT '{tmp_path}/db.vssdb'")
            db3 = Database.open(f"{tmp_path}/db.vssdb", device=CPU)
            r = db3.sql("SELECT name, score FROM p")
            assert r["name"].tolist() == ["alpha", None, "c"]
            assert r["score"][0] == 1.0 and np.isnan(r["score"][2])

    def test_pragma_info_schema_is_column_exact(self, db):
        """Round-5 (VERDICT r4 #8): pragma_hnsw_index_info() reproduces the
        reference's 11-column schema exactly, incl. the per-level STRUCT
        fields (hnsw_index_pragmas.cpp:41-80)."""
        db.sql("CREATE INDEX my_idx ON items USING HNSW (vec)")
        info = db.sql("SELECT * FROM pragma_hnsw_index_info()")
        assert list(info) == [
            "catalog_name", "schema_name", "index_name", "table_name",
            "metric", "dimensions", "count", "capacity",
            "approx_memory_usage", "levels", "levels_stats",
        ]
        assert info["catalog_name"][0] == "memory"
        assert info["schema_name"][0] == "main"
        assert info["index_name"][0] == "my_idx"
        assert info["table_name"][0] == "items"
        assert info["metric"][0] == "l2sq"
        assert info["dimensions"][0] == 3
        assert info["count"][0] == 729
        assert info["capacity"][0] >= 729
        assert info["approx_memory_usage"][0] > 0
        # levels = stats->max_level (0-based top level)
        stats = db.hnsw_index_info()[0]
        assert info["levels"][0] == stats["num_levels"] - 1
        lv = info["levels_stats"][0]
        assert [sorted(s) for s in lv] == [
            sorted(["nodes", "edges", "max_edges", "allocated_bytes"])
        ] * len(lv)
        assert lv[0]["nodes"] == 729 and lv[0]["allocated_bytes"] > 0
        # single-column projection still works (the reference tests'
        # `SELECT count FROM pragma_hnsw_index_info()` shape)
        assert db.sql("SELECT count FROM pragma_hnsw_index_info()")["count"][0] == 729


class TestLateral:
    """Ports `tests/test_lateral.py`."""

    @pytest.fixture
    def db(self):
        """The tables from hnsw_lateral_join.test:6-16."""
        d = Database(device=CPU)
        d.sql("CREATE TABLE a (a_vec FLOAT[3], a_id INT)")
        d.sql("CREATE TABLE b (b_vec FLOAT[3], b_str VARCHAR)")
        d.sql("INSERT INTO a VALUES ([1.0, 2.0, 3.0], 1), ([4.0, 5.0, 6.0], 2)")
        d.sql("INSERT INTO b VALUES ([4.0, 5.0, 6.0], 'b'), ([1.0, 2.0, 3.0], 'a')")
        return d

    def test_lateral_basic(self, db):
        """hnsw_lateral_join.test:22-27 — rows + intra-subquery projection of
        an outer column."""
        db.sql("CREATE INDEX my_idx ON b USING HNSW (b_vec)")
        assert "HNSW_INDEX_JOIN" in db.sql("EXPLAIN " + Q_BASIC)["explain"][0]
        r = db.sql(Q_BASIC)
        assert rows(r, ("a_id", "b_str", "id_dup")) == [(1, "a", 1), (2, "b", 2)]
        # vector columns from both sides come through
        assert np.allclose(sorted(r["a_vec"].tolist()), sorted(r["b_vec"].tolist()))

    def test_lateral_projected_distance(self, db):
        """hnsw_lateral_join.test:31-36 — distance aliased inside the subquery
        and referenced by ORDER BY."""
        db.sql("CREATE INDEX my_idx ON b USING HNSW (b_vec)")
        assert "HNSW_INDEX_JOIN" in db.sql("EXPLAIN " + Q_PROJ)["explain"][0]
        r = db.sql(Q_PROJ)
        assert np.allclose(np.sort(r["dist"]), [0.0, 0.0])
        assert rows(r, ("a_id", "b_str")) == [(1, "a"), (2, "b")]

    def test_lateral_indexed_matches_unindexed(self, db):
        """The labeled-equivalence technique (hnsw_lateral_join.test:39-47):
        same query with and without the index must agree."""
        want = rows(db.sql(Q_LIMIT2), ("a_id", "b_str", "id_dup"))
        db.sql("CREATE INDEX my_idx ON b USING HNSW (b_vec)")
        assert "HNSW_INDEX_JOIN" in db.sql("EXPLAIN " + Q_LIMIT2)["explain"][0]
        assert rows(db.sql(Q_LIMIT2), ("a_id", "b_str", "id_dup")) == want

    def test_lateral_null_inner(self, db):
        """hnsw_lateral_join.test:49-61 — NULL inner vectors sort last on the
        brute plan and are absent from the index; results agree while >= k
        non-NULL rows exist."""
        db.sql("INSERT INTO b VALUES (NULL, 'none')")
        want = rows(db.sql(Q_LIMIT2), ("a_id", "b_str"))
        assert want == [(1, "a"), (1, "b"), (2, "a"), (2, "b")]
        db.sql("CREATE INDEX my_idx ON b USING HNSW (b_vec)")
        assert rows(db.sql(Q_LIMIT2), ("a_id", "b_str")) == want

    def test_lateral_secondary_order_key_falls_back(self, db):
        """hnsw_lateral_join.test:63-76 — a second ORDER BY key blocks the
        index rewrite (the reference requires exactly one ASC window order,
        hnsw_optimize_join.cpp:479); results must still be correct, including
        a NULL outer vector whose rows order purely by the tiebreak key."""
        db.sql("INSERT INTO b VALUES (NULL, 'none')")
        db.sql("INSERT INTO a VALUES (NULL, 3)")
        want = rows(db.sql(Q_TWO_KEYS), ("a_id", "b_str"))
        # NULL outer -> all-NULL distances -> b_str DESC picks 'none', 'b'
        assert want == [
            (1, "a"), (1, "b"), (2, "a"), (2, "b"), (3, "b"), (3, "none"),
        ]
        db.sql("CREATE INDEX my_idx ON b USING HNSW (b_vec)")
        plan = db.sql("EXPLAIN " + Q_TWO_KEYS)["explain"][0]
        assert "LATERAL_TOPK_JOIN" in plan and "HNSW_INDEX_JOIN" not in plan
        assert rows(db.sql(Q_TWO_KEYS), ("a_id", "b_str")) == want

    def test_lateral_group_by(self, db):
        """hnsw_lateral_join.test:78-87 — list() aggregate over the join,
        grouped by the outer id."""
        q = (
            "select a_id, list(b_str ORDER BY array_distance(a.a_vec, b.b_vec)"
            ", b_str) from a, lateral (select *, a_id as id_dup from b order "
            "by array_distance(a.a_vec, b.b_vec), b_str limit 2) GROUP BY a_id"
        )
        want = db.sql(q)
        assert dict(zip(want["a_id"].tolist(), want["list"].tolist())) == {
            1: ["a", "b"], 2: ["b", "a"],
        }

    def test_min_by_filter_preserved(self):
        """min_by(...) FILTER (WHERE p) survives the index rewrite and applies
        over the scanned rows (hnsw_optimize_topk.cpp:193)."""
        d = Database(device=CPU)
        d.sql("CREATE TABLE t (id BIGINT, vec FLOAT[2])")
        vecs = np.stack([np.arange(20), np.zeros(20)], axis=1).astype(np.float32)
        d.insert("t", {"id": np.arange(20), "vec": vecs})
        q = (
            "SELECT min_by(id, array_distance(vec, [0.0, 0.0]), 5) "
            "FILTER (WHERE id > 1) FROM t"
        )
        r = d.sql(q)
        assert list(r["min_by"][0]) == [2, 3, 4, 5, 6]
        d.sql("CREATE INDEX i ON t USING HNSW (vec)")
        plan = d.sql("EXPLAIN " + q)["explain"][0]
        assert "HNSW_INDEX_SCAN" in plan and "FILTER" in plan
        # index path: filter applies within the k scanned rows (reference
        # semantics) -> subset of the brute answer
        r2 = d.sql(q)
        assert list(r2["min_by"][0]) == [2, 3, 4]

    def test_max_by_sql(self):
        """max_by(value, order, k): descending order, no index rewrite."""
        d = Database(device=CPU)
        d.sql("CREATE TABLE t (id BIGINT, score FLOAT)")
        d.insert("t", {"id": np.arange(6), "score": np.asarray([3., 1., 5., 2., 4., 0.])})
        r = d.sql("SELECT max_by(id, score, 3) FROM t")
        assert list(r["max_by"][0]) == [2, 4, 0]

    def test_order_by_multiple_keys_top_level(self):
        d = Database(device=CPU)
        d.sql("CREATE TABLE t (g BIGINT, v FLOAT)")
        d.insert("t", {"g": np.asarray([1, 0, 1, 0]), "v": np.asarray([2., 3., 1., 4.])})
        r = d.sql("SELECT g, v FROM t ORDER BY g, v DESC")
        assert r["g"].tolist() == [0, 0, 1, 1]
        assert r["v"].tolist() == [4.0, 3.0, 2.0, 1.0]


class TestLateralGroupLarge:
    """hnsw_lateral_join_group.test — 2 queries x 2k items, alias group
    keys, ordered list(), indexed/unindexed parity."""

    Q_SCAN = """
        SELECT queries.id as id, nbr
        FROM queries, LATERAL (
            SELECT items.id as nbr,
                   array_distance(items.embedding, queries.embedding) as dist
            FROM items ORDER BY dist LIMIT 3
        )"""
    Q_GROUP = """
        SELECT queries.id as id, list(nbr ORDER BY dist, nbr)
        FROM queries, LATERAL (
            SELECT items.id as nbr,
                   array_distance(queries.embedding, items.embedding) as dist
            FROM items ORDER BY dist LIMIT 3
        ) GROUP BY id"""

    @pytest.fixture
    def db2(self, rng):
        d = Database(device=CPU)
        d.sql("CREATE TABLE queries (id INT, embedding FLOAT[3])")
        d.sql("INSERT INTO queries VALUES (1, [5, 5, 5]), (2, [42, 42, 42])")
        d.sql("CREATE TABLE items (id INT, embedding FLOAT[3])")
        d.insert(
            "items",
            {
                "id": np.arange(1, 2001),
                "embedding": rng.random((2000, 3)).astype(np.float32),
            },
        )
        return d

    def test_parity(self, db2):
        scan = rows(db2.sql(self.Q_SCAN), ("id", "nbr"))
        grp = db2.sql(self.Q_GROUP)
        grp_want = dict(zip(grp["id"].tolist(), grp["list"].tolist()))
        db2.sql("CREATE INDEX items_embedding_idx ON items USING HNSW (embedding)")
        plan = db2.sql("EXPLAIN " + self.Q_SCAN)["explain"][0]
        assert "HNSW_INDEX_JOIN" in plan
        assert rows(db2.sql(self.Q_SCAN), ("id", "nbr")) == scan
        grp2 = db2.sql(self.Q_GROUP)
        assert dict(zip(grp2["id"].tolist(), grp2["list"].tolist())) == grp_want


class TestFuzz:
    """Ports `tests/test_fuzz.py`."""

    def test_random_crud_against_oracle(self, rng):
        cfg = HNSWConfig(dims=D, m=8, ef_construction=64)
        idx = HNSWIndex(cfg, capacity=64, device=CPU)
        oracle: dict[int, np.ndarray] = {}
        next_id = 0
        checks = 0
        for step in range(60):
            op = rng.choice(["insert", "delete", "compact", "update"],
                            p=[0.55, 0.25, 0.05, 0.15])
            if op == "insert" or not oracle:
                n = int(rng.integers(1, 20))
                vecs = rng.standard_normal((n, D)).astype(np.float32)
                ids = list(range(next_id, next_id + n))
                next_id += n
                idx.insert(vecs, ids)
                for i, r in enumerate(ids):
                    oracle[r] = vecs[i]
            elif op == "delete":
                kill = rng.choice(list(oracle), size=min(len(oracle), int(rng.integers(1, 8))), replace=False)
                assert idx.delete([int(r) for r in kill]) == len(kill)
                for r in kill:
                    del oracle[int(r)]
            elif op == "compact":
                idx.compact()
            elif op == "update":
                r = int(rng.choice(list(oracle)))
                nv = rng.standard_normal(D).astype(np.float32)
                idx.delete([r])
                idx.insert(nv[None], [r])
                oracle[r] = nv
            assert idx.count == len(oracle), (step, op)

            if oracle and step % 5 == 4:
                checks += 1
                q = rng.standard_normal((3, D)).astype(np.float32)
                k = min(5, len(oracle))
                d, rows = idx.search(q, k=k, ef=64)
                d, rows = np.asarray(d), np.asarray(rows)
                hits = total = 0
                for b in range(3):
                    want = exact_topk(oracle, q[b], k)
                    got = [int(r) for r in rows[b] if r >= 0]
                    # every returned row must be live with a correct distance
                    for j, r in enumerate(got):
                        assert r in oracle, (step, r)
                        true_d = float(((oracle[r] - q[b]) ** 2).sum())
                        assert abs(true_d - float(d[b, j])) < 1e-2 + 1e-3 * abs(true_d)
                    hits += len(set(got) & set(want))
                    total += len(want)
                assert hits / total >= 0.75, f"step {step}: recall {hits}/{total}"
        assert checks >= 10


class TestSQLTableFunctions:
    """Ports `tests/test_misc_api.py::test_sql_table_functions`."""

    def test_sql_table_functions(self, rng):
        db = Database(device=CPU)
        g = rng.standard_normal((100, 4)).astype(np.float32)
        q = g[:10] + 0.01
        db.create_table("items", {"id": np.arange(100), "vec": g})
        db.create_table("queries", {"qid": np.arange(10), "qvec": q})
        r = db.sql("SELECT * FROM vss_join(queries, items, qvec, vec, 2)")
        assert len(r["left_qid"]) == 20
        r = db.sql("SELECT * FROM vss_join(queries, items, qvec, vec, 2, 'cosine')")
        assert len(r["score"]) == 20
        vec_lit = "[" + ",".join(f"{x:.4f}" for x in g[7]) + "]"
        r = db.sql(f"SELECT * FROM vss_match(items, {vec_lit}, vec, 3)")
        assert r["id"][0] == 7
        r = db.sql("SELECT * FROM knn_join(queries, items, qvec, vec, 2)")
        assert len(r["l_qid"]) == 20
        assert r["r_id"][0] == 0  # nearest to q[0] = g[0]+eps is item 0
        # index-accelerated once an index exists
        db.create_hnsw_index("i", "items", "vec")
        r2 = db.sql("SELECT * FROM knn_join(queries, items, qvec, vec, 2)")
        assert r2["r_id"][0] == 0
        with pytest.raises(Exception, match="vss_join"):
            db.sql("SELECT * FROM vss_join(queries, items)")


class TestStorageOptionsSQL:
    """Ports `tests/test_bf16.py`'s SQL tests."""

    def test_bf16_sql_and_persistence(self, rng, tmp_path):
        db = Database(device=CPU)
        vecs = rng.standard_normal((400, 8)).astype(np.float32)
        db.create_table("t", {"id": np.arange(400), "vec": vecs})
        db.sql("CREATE INDEX bi ON t USING HNSW (vec) WITH (storage = 'bf16')")
        assert db.indexes["bi"].index.config.storage_dtype == "bf16"
        r = db.sql("SELECT id FROM t ORDER BY array_distance(vec, " +
                   "[" + ",".join(f"{x:.4f}" for x in vecs[7]) + "]) LIMIT 1")
        assert r["id"][0] == 7
        db.set_setting("hnsw_enable_experimental_persistence", True)
        db.checkpoint(str(tmp_path / "db"))
        db2 = Database.open(str(tmp_path / "db"), device=CPU)
        assert db2.indexes["bi"].index.graph.vectors.dtype == torch.bfloat16
        r = db2.sql("SELECT id FROM t ORDER BY array_distance(vec, " +
                    "[" + ",".join(f"{x:.4f}" for x in vecs[7]) + "]) LIMIT 1")
        assert r["id"][0] == 7

    def test_bad_storage_option(self):
        db = Database(device=CPU)
        db.create_table("t", {"vec": np.ones((10, 4), np.float32)})
        with pytest.raises(BinderError, match="storage"):
            db.create_hnsw_index("i", "t", "vec", storage="f64")

    def test_int8_sql_option(self, rng):
        db = Database(device=CPU)
        db.create_table("t", {"id": np.arange(100),
                              "vec": rng.uniform(0, 255, (100, 8)).astype(np.float32)})
        db.sql("CREATE INDEX qi ON t USING HNSW (vec) WITH (storage = 'int8')")
        assert db.indexes["qi"].index.config.storage_dtype == "int8"


class TestShardedIndexSQL:
    """`tests/test_sharded.py::test_sharded_index_in_database` on the port.
    The JAX package's default mesh has the 8 virtual devices of its test
    harness; the port's default mesh has one slot per visible device of
    the database's type (one on the CPU), so the 8-shard case passes
    `make_mesh(8, device="cpu")` and the SQL form is checked apart."""

    def test_sharded_index_in_database(self, rng, tmp_path):
        from vss_tpu_torch import col, const, fn
        from vss_tpu_torch.parallel import ShardedHNSWIndex, make_mesh
        from vss_tpu_torch.storage.blockfile import blockstore_available

        db = Database(device=CPU)
        vecs = rng.standard_normal((400, 8)).astype(np.float32)
        db.create_table("t", {"id": np.arange(400), "vec": vecs})
        db.sql("CREATE INDEX si ON t USING HNSW (vec) WITH (sharded = TRUE)")
        assert isinstance(db.indexes["si"].index, ShardedHNSWIndex)
        assert db.hnsw_index_info()[0]["n_shards"] == make_mesh(device=CPU).size == 1
        db.drop_index("si")
        db.create_hnsw_index("si", "t", "vec", sharded=True, mesh=make_mesh(8, device=CPU))
        vec_lit = "[" + ",".join(f"{x:.4f}" for x in vecs[7]) + "]"
        exp = db.sql(f"EXPLAIN SELECT id FROM t ORDER BY array_distance(vec, {vec_lit}) LIMIT 1")
        assert "HNSW_INDEX_SCAN" in exp["explain"][0]
        r = db.sql(f"SELECT id FROM t ORDER BY array_distance(vec, {vec_lit}) LIMIT 1")
        assert r["id"][0] == 7
        # a pushed filter: the [S, cap] mask of the sharded index
        r = db.sql(f"SELECT id FROM t WHERE id % 2 = 1 ORDER BY array_distance(vec, "
                   f"{vec_lit}) LIMIT 5")
        assert len(r["id"]) == 5 and all(int(i) % 2 == 1 for i in r["id"])
        # DML maintenance through the sharded index
        db.insert("t", {"id": [900], "vec": (vecs[:1] + 50.0)})
        r = db.query("t").order_by(
            fn("array_distance", col("vec"), const(vecs[0] + 50.0))
        ).limit(1).select("id").execute()
        assert r["id"][0] == 900
        db.delete("t", [900])
        # info + compact pragmas
        info = db.hnsw_index_info()
        assert info[0]["n_shards"] == 8
        db.hnsw_compact_index("si")
        # persistence: directory checkpoint
        db.set_setting("hnsw_enable_experimental_persistence", True)
        p = str(tmp_path / "sharded_db")
        db.checkpoint(p)
        db2 = Database.open(p, device=CPU)
        assert db2.indexes["si"].index.n_shards == 8
        r = db2.sql(f"SELECT id FROM t ORDER BY array_distance(vec, {vec_lit}) LIMIT 1")
        assert r["id"][0] == 7
        # single-file checkpoint too (if the toolchain is present)
        if blockstore_available():
            p2 = str(tmp_path / "sharded.vssdb")
            db.checkpoint(p2)
            db3 = Database.open(p2, device=CPU)
            assert db3.indexes["si"].index.n_shards == 8
            r = db3.sql(f"SELECT id FROM t ORDER BY array_distance(vec, {vec_lit}) LIMIT 1")
            assert r["id"][0] == 7
