"""The SQLLogic runner of vss_tpu_torch (`vss_tpu_torch/testing/sqllogic.py`).

The reference's own SQLLogic files run through the port's runner when the
duckdb-vss checkout that `tests/test_sqllogic_reference.py` reads is
present, with the same concession for DuckDB's PRNG-dependent blocks, and
skip otherwise. A file written here runs through both packages' runners
on every machine: statements, expected errors, results, labels, the
plan-shape regexes and `load` / `restart` (a checkpoint and a reopen).
"""
import os

import pytest

from test_sqllogic_reference import _FILES, _SKIP_INLINE, REF_DIR
from vss_tpu.testing.sqllogic import run_sqllogic_file as run_jax
from vss_tpu_torch.testing.sqllogic import run_sqllogic_file

SCRIPT = """\
require vss

load __TEST_DIR__/logic.vssdb

statement ok
SET hnsw_enable_experimental_persistence = true;

statement ok
CREATE TABLE t (id INT, vec FLOAT[3]);

statement ok
INSERT INTO t VALUES (1, [1.0, 2.0, 3.0]), (2, [4.0, 5.0, 6.0]), (3, [7.0, 8.0, 9.0]), (4, [1.0, 2.0, 4.0]);

statement ok
CREATE INDEX idx ON t USING HNSW (vec) WITH (metric = 'l2sq');

query II
EXPLAIN SELECT id FROM t ORDER BY array_distance(vec, [1.0, 2.0, 3.0]::FLOAT[3]) LIMIT 2;
----
physical_plan	<REGEX>:.*HNSW_INDEX_SCAN.*

query I nosort indexed
SELECT id FROM t ORDER BY array_distance(vec, [1.0, 2.0, 3.0]::FLOAT[3]) LIMIT 2;
----
1
4

statement error
CREATE INDEX idx2 ON t USING HNSW (vec) WITH (metric = 'nope');
----
HNSW index 'metric' must be one of

statement ok
DELETE FROM t WHERE id = 1;

statement ok
PRAGMA hnsw_compact_index('idx');

restart

query I rowsort
SELECT id FROM t ORDER BY array_distance(vec, [1.0, 2.0, 3.0]::FLOAT[3]) LIMIT 3;
----
2
3
4

statement ok
DROP INDEX idx;

query I nosort
SELECT min_by(id, array_distance(vec, [7.0, 8.0, 9.0]::FLOAT[3]), 1) FROM t;
----
[3]
"""


@pytest.mark.skipif(not _FILES, reason="reference test dir not present")
@pytest.mark.parametrize("fname", _FILES)
def test_reference_sqllogic_file(fname, tmp_path):
    res = run_sqllogic_file(
        os.path.join(REF_DIR, fname),
        str(tmp_path),
        skip_inline_labels=_SKIP_INLINE.get(fname, ()),
        device="cpu",
    )
    assert res.unmet_require is None, f"unmet require: {res.unmet_require}"
    fails = res.failures()
    msg = "\n".join(
        f"  line {r.line} [{r.kind}] {r.sql.splitlines()[0][:80]}\n"
        f"    -> {r.detail}"
        for r in fails
    )
    assert not fails, f"{len(fails)} failing records in {fname}:\n{msg}"


@pytest.mark.parametrize("runner", ["vss_tpu_torch", "vss_tpu"])
def test_runner_on_a_written_file(runner, tmp_path):
    path = tmp_path / "logic.test"
    path.write_text(SCRIPT)
    data = tmp_path / "data"
    data.mkdir()
    if runner == "vss_tpu":
        res = run_jax(str(path), str(data))
    else:
        res = run_sqllogic_file(str(path), str(data), device="cpu")
    assert res.unmet_require is None
    fails = [(r.line, r.sql, r.detail) for r in res.failures()]
    assert not fails, fails
    assert len(res.records) == 14
