"""The general traffic generator: churn's live range, the fixed recall
steps, the pool in turn, the reservoir drawn from the seed."""
import numpy as np
import pytest

from vssbench.data import Corpus
from vssbench.loop import Loop

SPEC = {"generator": "sift_like", "rows": 5000, "dims": 4, "centres": 8, "noise_sd": 2.0,
        "low": 0.0, "high": 255.0, "chunk_rows": 300}
CHURN = {"ops": [{"op": "insert", "rows": 100}, {"op": "delete", "rows": 100},
                 {"op": "search", "batch": 64, "k": 3, "ef": 8},
                 {"op": "search", "batch": 64, "k": 3, "ef": 8}],
         "warmup_steps": 2, "recall_steps": [2, 5], "reservoir_calls": 3, "trace_steps": 1,
         "prepare_steps": 4}


class Recorder:
    """A system that records what it is asked and answers with the live
    range's first ids."""

    def __init__(self):
        self.calls = []
        self.live = set(range(5000))

    def search(self, q, k, ef):
        self.calls.append(("search", q.copy()))
        ids = np.array(sorted(self.live)[:k])
        return np.zeros((q.shape[0], k), np.float32), np.tile(ids, (q.shape[0], 1))

    def insert(self, rows, ids):
        self.calls.append(("insert", rows.copy(), ids.copy()))
        self.live |= set(ids.tolist())

    def delete(self, ids):
        self.calls.append(("delete", ids.copy()))
        self.live -= set(ids.tolist())


def make(traffic, seed=5):
    corpus = Corpus(SPEC, seed, "cpu")
    pool = corpus.queries(150).numpy()
    sys_ = Recorder()
    return Loop(traffic, sys_, pool, corpus, seed), sys_, corpus, pool


def test_churn_slides_the_live_range():
    loop, sys_, corpus, _ = make(CHURN)
    loop.prepare()
    loop.warmup()
    loop.window(0.0)
    out = loop.finish()
    assert out.steps == 3 and loop.step == 6  # ran on to the last recall step
    inserts = [c for c in sys_.calls if c[0] == "insert"]
    deletes = [c for c in sys_.calls if c[0] == "delete"]
    for s, (ins, dele) in enumerate(zip(inserts, deletes)):
        assert ins[2].tolist() == list(range(5000 + 100 * s, 5100 + 100 * s))
        assert dele[1].tolist() == list(range(100 * s, 100 * s + 100))
    # the inserted rows are the stream's, in order, across chunk borders
    stream = np.concatenate([corpus.chunk(c).numpy() for c in range(3)])
    assert np.array_equal(inserts[3][1], stream[300:400])
    assert (out.lo, out.hi) == (600, 5600)
    assert sys_.live == set(range(600, 5600))


def test_recall_steps_keep_both_searches_with_their_range():
    loop, _, _, _ = make(CHURN)
    loop.warmup()
    loop.window(0.0)
    out = loop.finish()
    kept = [(a.step, a.lo, a.hi) for a in out.answers]
    assert kept == [(2, 300, 5300), (2, 300, 5300), (5, 600, 5600), (5, 600, 5600)]


def test_the_pool_is_read_in_turn_and_wraps():
    loop, sys_, _, pool = make(CHURN)
    loop.warmup()
    loop.window(0.0)
    loop.finish()
    qs = [c[1] for c in sys_.calls if c[0] == "search"]
    flat = np.concatenate(qs)
    expect = pool[np.arange(flat.shape[0]) % 150]
    assert np.array_equal(flat, expect)


def test_warmup_steps_are_not_in_the_window():
    loop, _, _, _ = make(CHURN)
    loop.warmup()
    loop.window(0.0)
    out = loop.finish()
    phases = [(o.step, o.phase) for o in out.ops if o.kind == "insert"]
    assert phases[:3] == [(0, "warmup"), (1, "warmup"), (2, "window")]
    assert all(p == "post" for s, p in phases[3:])
    assert len(out.window_ops(("search",))) == 2


def test_the_reservoir_is_drawn_from_the_seed():
    t = dict(CHURN, recall_steps=[2])

    def sampled(seed):
        loop, _, _, _ = make(t, seed)
        loop.warmup()
        loop.window(0.3)
        out = loop.finish()
        return len(out.window_ops(("search",))), [a.step for a in out.sampled]

    n, a = sampled(11)
    assert len(a) == min(3, n)
    if n > 6:
        draws = {tuple(sampled(s)[1]) for s in range(12, 16)}
        assert len(draws) > 1


def test_a_raising_request_counts_as_failed():
    loop, sys_, _, _ = make(dict(CHURN, recall_steps=[2]))

    def boom(*a):
        raise RuntimeError("no")

    sys_.delete = boom
    loop.warmup()
    loop.window(0.0)
    out = loop.finish()
    assert out.failed == 3 and out.lo == 0 and "RuntimeError" in out.errors[0]


def test_a_recall_step_in_the_warmup_is_refused(tmp_path):
    import json

    from vssbench.loop import load_traffic

    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "x.json").write_text(json.dumps(dict(CHURN, recall_steps=[1])))
    with pytest.raises(ValueError):
        load_traffic("x", str(tmp_path))
