"""The one general traffic generator: a closed loop, one client, that
runs the step program of a traffic file over a system.

A traffic file (`traffic/<name>.json`) lists the operations of one step:

- `{"op": "search", "batch": B, "k": k, "ef": ef}`: `HNSWIndex.search` of
  the next B queries of the pool (the pool is read in turn, wrapping);
- `{"op": "scan_search", "batch": B, "k": k}`: `HNSWIndex.scan_search`;
- `{"op": "insert", "rows": n}`: the next n rows of the stream, with the
  next n ids after the live range;
- `{"op": "delete", "rows": n}`: the n oldest live ids.

The live rows are always one range of ids [lo, hi): the base corpus is
ids [0, N), inserts extend the range and deletes shrink it from below.
A request hands its queries or rows over as host float32 and ends when
its answer (or, for a write, its acknowledgement, with the device work
finished) is on the host.

Steps 0 .. warmup_steps-1 run in set-up. The measured window then runs
whole steps until `seconds` have passed. The searches of the steps in
`recall_steps` are kept for recall and for the check; steps past the
window that a slow run has not reached yet run after it closes, untimed.
A reservoir of `reservoir_calls` read calls, drawn from the seed over
every read call of the window, is kept for the check as well.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np

from vssbench.data import subseed

READS = ("search", "scan_search")
WRITES = ("insert", "delete")
_HERE = os.path.dirname(os.path.abspath(__file__))


def load_traffic(name: str, root: str = _HERE) -> dict:
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        t = json.load(f)
    for op in t["ops"]:
        if op["op"] not in READS + WRITES:
            raise ValueError(f"traffic {name}: unknown op {op['op']!r}")
    t.setdefault("warmup_steps", 2)
    t.setdefault("reservoir_calls", 16)
    t.setdefault("trace_steps", 32)
    t.setdefault("prepare_steps", 0)
    if min(t["recall_steps"]) < t["warmup_steps"]:
        raise ValueError(f"traffic {name}: a recall step lies in the warm-up")
    return t


@dataclass
class Op:
    """One request: which op, at which step, its host-clock span."""
    kind: str
    step: int
    t0: float
    t1: float
    items: int
    phase: str          # "warmup", "window" or "post"
    profiled: bool = False


@dataclass
class Answer:
    """A read call kept for recall and the check."""
    step: int
    pool_start: int
    k: int
    lo: int
    hi: int
    dists: np.ndarray   # [B, k] float32, host
    ids: np.ndarray     # [B, k] int64, host
    q: np.ndarray | None = None   # the queries, where not from the pool


@dataclass
class Outcome:
    ops: list = field(default_factory=list)
    answers: list = field(default_factory=list)     # recall steps
    sampled: list = field(default_factory=list)     # the reservoir
    failed: int = 0
    errors: list = field(default_factory=list)
    window_s: float = 0.0
    steps: int = 0
    lo: int = 0
    hi: int = 0
    inserted: int = 0

    def window_ops(self, kinds):
        return [o for o in self.ops if o.phase == "window" and o.kind in kinds]


class Stream:
    """The inserted rows on the host, chunk by chunk of the corpus."""

    def __init__(self, corpus):
        self.corpus = corpus
        self.host: dict[int, np.ndarray] = {}

    def prepare(self, n_rows: int):
        for c in range(-(-n_rows // self.corpus.chunk_rows)):
            self._chunk(c)

    def _chunk(self, c: int) -> np.ndarray:
        if c not in self.host:
            self.host[c] = self.corpus.chunk(c).cpu().numpy()
        return self.host[c]

    def take(self, offsets: np.ndarray) -> np.ndarray:
        """Stream rows at the given stream offsets."""
        cr = self.corpus.chunk_rows
        return np.stack([self._chunk(int(o) // cr)[int(o) % cr] for o in offsets])

    def rows(self, start: int, n: int) -> np.ndarray:
        """Stream rows start .. start+n-1 (stream offsets, not ids)."""
        cr = self.corpus.chunk_rows
        parts = []
        while n:
            c, off = divmod(start, cr)
            take = min(n, cr - off)
            parts.append(self._chunk(c)[off:off + take])
            start += take
            n -= take
        return parts[0] if len(parts) == 1 else np.concatenate(parts)


class Loop:
    """Runs one traffic file's steps over `system` (see the module's
    docstring). `tracer`, where given, profiles `trace_steps` steps from
    a third of the window on."""

    def __init__(self, traffic: dict, system, pool: np.ndarray, corpus, seed: int,
                 tracer=None):
        self.t = traffic
        self.system = system
        self.corpus = corpus
        self.pool_n = pool.shape[0]
        width = max([op.get("batch", 0) for op in traffic["ops"]] + [0])
        reps = -(-width // self.pool_n) + 1
        # the pool followed by its start again: every batch is one slice
        self.pool = np.ascontiguousarray(np.concatenate([pool] * reps)[: self.pool_n + width])
        self.stream = Stream(corpus)
        self.tracer = tracer
        self.rng = np.random.default_rng(subseed(seed, "reservoir"))
        self.reads_done = 0      # queries drawn from the pool so far
        self.window_reads = 0    # read calls of the window so far
        self.lo, self.hi = 0, corpus.rows
        self.inserted = 0
        self.step = 0
        self.out = Outcome()

    def prepare(self):
        """Set-up: the stream rows of `prepare_steps` steps onto the host."""
        per_step = sum(op["rows"] for op in self.t["ops"] if op["op"] == "insert")
        self.stream.prepare(per_step * self.t["prepare_steps"])

    def _op(self, spec: dict, phase: str, profiled: bool):
        kind = spec["op"]
        keep = phase != "warmup" and kind in READS and self.step in self.t["recall_steps"]
        if kind in READS:
            b = spec["batch"]
            start = self.reads_done % self.pool_n
            q = self.pool[start:start + b]
            self.reads_done += b
        elif kind == "insert":
            n = spec["rows"]
            rows = self.stream.rows(self.inserted, n)
            ids = np.arange(self.hi, self.hi + n, dtype=np.int64)
        else:
            n = min(spec["rows"], self.hi - self.lo)
            ids = np.arange(self.lo, self.lo + n, dtype=np.int64)
        ok = True
        t0 = time.perf_counter()
        try:
            with self._span(kind, profiled):
                if kind == "search":
                    d, ids_out = self.system.search(q, spec["k"], spec.get("ef"))
                elif kind == "scan_search":
                    d, ids_out = self.system.scan_search(q, spec["k"])
                elif kind == "insert":
                    self.system.insert(rows, ids)
                else:
                    self.system.delete(ids)
        except (RuntimeError, ValueError, IndexError) as e:
            ok = False
            self.out.failed += 1
            self.out.errors.append(f"step {self.step} {kind}: {type(e).__name__}: {e}")
        t1 = time.perf_counter()
        if kind == "insert" and ok:
            self.hi += n
            self.inserted += n
        elif kind == "delete" and ok:
            self.lo += n
        items = spec.get("batch", spec.get("rows", 0))
        self.out.ops.append(Op(kind, self.step, t0, t1, items, phase, profiled))
        if kind in READS and ok and phase != "warmup":
            ans = Answer(self.step, start, spec["k"], self.lo, self.hi,
                         np.asarray(d, np.float32), np.asarray(ids_out, np.int64))
            if keep:
                self.out.answers.append(ans)
            if phase == "window":
                self._reservoir(ans)

    def _reservoir(self, ans: Answer):
        r = self.t["reservoir_calls"]
        n = self.window_reads
        self.window_reads += 1
        if n < r:
            self.out.sampled.append(ans)
        else:
            j = int(self.rng.integers(0, n + 1))
            if j < r:
                self.out.sampled[j] = ans

    def _span(self, kind, profiled):
        if profiled and self.tracer is not None:
            return self.tracer.span(kind)
        return contextlib.nullcontext()

    def _run_step(self, phase: str, profiled: bool = False):
        for spec in self.t["ops"]:
            self._op(spec, phase, profiled)
        self.step += 1

    def warmup(self):
        while self.step < self.t["warmup_steps"]:
            self._run_step("warmup")

    def window(self, seconds: float):
        """Whole steps until `seconds` have passed. With a tracer, from a
        third of the window on, `trace_steps` steps under each of its
        phases in turn, and the window does not close before they are."""
        phases = list(self.tracer.PHASES) if self.tracer is not None else []
        n = self.t["trace_steps"]
        traced = 0
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            profiled = bool(phases) and now >= seconds / 3.0
            if profiled and traced == 0:
                self.tracer.start(phases[0])
            self._run_step("window", profiled)
            if profiled:
                traced += 1
                if traced == n:
                    self.tracer.stop()
                    phases.pop(0)
                    traced = 0
            # a traced run reports no end-to-end metric: its window runs on
            # until every phase of the trace is done
            if time.perf_counter() - t0 >= seconds and not phases:
                break
        self.out.window_s = time.perf_counter() - t0
        self.out.steps = self.step

    def finish(self):
        """Untimed steps up to the last recall step."""
        while self.step <= max(self.t["recall_steps"]):
            self._run_step("post")
        self.out.lo, self.out.hi, self.out.inserted = self.lo, self.hi, self.inserted
        return self.out
