"""The CUDA source of the `rerank_pool` kernel (`csrc/rerank.cu`: the graph
search's f32 rerank), compiled with g++ and run on the CPU, against its
plain version `_rerank_pool_plain` (the torch ops `hnsw_search` ran before
it).

There is no nvcc and no card where these tests run, so the kernel itself
is held against the plain version only on the card (`chip_smoke.py`,
`check_rerank_pool`, and the test marked `cuda` below). What runs here is
its C++: `tests/cuda_emulation.h` stands in for the CUDA headers and runs a
block's threads as cooperative fibers that switch at every barrier and
warp exchange; `tests/emulation.py` turns the `<<<...>>>` launch into a
call and the dynamic shared memory into a pointer, and changes nothing
else.

The contract is exact on integer-valued data, where every f32 sum is exact
whatever its order: ids equal and distances bit for bit (cosine within
COS_TOL, ids equal up to near-ties), for l2sq, cosine and ip over f32 and
bf16 tapes; ef 10, 64 and 257 with k <= ef; d = 128 and 3,080 (16-byte
loads) and d = 6 (element loads: 24 or 12 bytes a row); pools wider than
the kernel sorts at a time (kRpChunk, 4,096 positions: sorted in chunks)
with k past it (written in rounds), also under an index search at such an
ef; -1 ids, equal rows at several pool positions (ties to the lower
position, not the lower id, across chunks too), NaN in queries and rows,
an empty batch and an empty graph. On real-valued data
the two versions sum in other orders, so distances agree within REAL_TOL
and ids up to near-ties. Three mutants (l2sq by the dot-product identity;
ties to the higher pool position; -1 ids scored as row 0) must each fail a
case. The emulation shows what the kernel computes, never how fast, and it
cannot show a missing barrier. One test, marked `cuda`, holds the kernel
itself against the plain version where a CUDA device is present and skips
elsewhere; on the card (no JAX there, so without this directory's
conftest): `python -m pytest --noconftest -o addopts="" -m cuda
tests/test_torch_rerank_pool_emulated.py -q`.
"""
import shutil

import numpy as np
import pytest
import torch

import emulation
import vss_tpu_torch.index.search as tsearch
from vss_tpu_torch import csrc
from vss_tpu_torch.ops.distance import Metric

# the three mutants: l2sq by qn + xn - 2 dot (the row's norm summed in the
# same pass, the query's norm read); positions stored reversed in the
# composite (ties to the higher position, positions still decoded right);
# a -1 id clamped to row 0 and scored
_MUTANTS = {
    "l2sq_dot_identity": [
        ("  if (l2) {\n    const float diff", "  if (false) {\n    const float diff"),
        ("v = l2 ? s0[u] : epilogue(s0[u], qnb, s1[u], a.metric);",
         "v = epilogue(s0[u], qnb, s1[u], a.metric);"),
        ("const float qnb = a.metric == COSINE ? a.qn[b] : 0.0f;",
         "const float qnb = a.metric != IP ? a.qn[b] : 0.0f;"),
    ],
    "ties_to_higher": [
        ("static_cast<unsigned>(p);", "static_cast<unsigned>(0x7fffffff - p);"),
        ("ids[static_cast<int>(c & 0xffffffffull)]",
         "ids[0x7fffffff - static_cast<int>(c & 0xffffffffull)]"),
    ],
    "minus_one_scored": [
        ("id[u] = i >= 0 && i < a.cap ? i : -1;", "id[u] = i < a.cap ? (i < 0 ? 0 : i) : -1;"),
    ],
}

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _build(tmp_path_factory, edits=()):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    work = tmp_path_factory.mktemp("cuda_emulation")
    emulation.setup(work)
    return emulation.build(work, ("rerank",), edits)["rerank"]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """librerank built by g++ from csrc/rerank.cu."""
    return _build(tmp_path_factory)


@pytest.fixture(scope="module", params=sorted(_MUTANTS))
def mutant(request, tmp_path_factory):
    return request.param, _build(tmp_path_factory, _MUTANTS[request.param])


def _route(monkeypatch, lib) -> list:
    """Route the kernel's launches to the emulated library; returns the
    list each launch's arguments are appended to."""
    fn = emulation.entry(lib, tsearch._RERANK)
    launched = []

    def launch(operands, *args):
        rc = fn(*args, None)
        if rc != 0:
            raise RuntimeError(f"rerank_pool: emulated launch refused ({rc})")
        launched.append(args)

    monkeypatch.setattr(tsearch._RERANK, "launch", launch)
    return launched


def _world(seed, B, ef, d, dtype, kind="integer", cap=300, neg=0.1):
    """(q [B, d] f32, pool ids [B, ef] i32, rerank tape [cap, d]). kind
    "integer": every value an integer small enough that each f32 sum of
    either version is exact, queries near tape rows, a share `neg` of the
    pool's ids -1. "ties": rows 2i and 2i + 1 equal, each pair in the
    pool with the higher id first. "real": N(0, 1) values."""
    rng = np.random.default_rng(seed)
    if kind == "real":
        x = rng.normal(size=(cap, d)).astype(np.float32)
        q = (x[rng.integers(0, cap, B)] + 0.3 * rng.normal(size=(B, d))).astype(np.float32)
    else:
        x = rng.integers(-40, 41, (cap, d)).astype(np.float32)
        q = (x[rng.integers(0, cap, B)] + rng.integers(-5, 6, (B, d))).astype(np.float32)
    ids = rng.integers(0, cap, (B, ef)).astype(np.int32)
    if kind == "ties":
        x[1::2] = x[0::2]
        pairs = rng.integers(0, cap // 2, (B, (ef + 1) // 2))
        ids = np.stack([2 * pairs + 1, 2 * pairs], 2).reshape(B, -1)[:, :ef].astype(np.int32)
        q = x[2 * pairs[:, 0]] + rng.integers(-1, 2, (B, d)).astype(np.float32)
    ids[rng.random((B, ef)) < neg] = -1
    tape = torch.from_numpy(x).to(_DTYPES[dtype])
    return torch.from_numpy(np.ascontiguousarray(q)), torch.from_numpy(ids), tape


def _entry(v=0):
    return torch.tensor(v, dtype=torch.int32)


def _run(lib, monkeypatch, world, k, metric, entry=None):
    """(the emulated kernel's (dists, ids), the plain version's, launches)."""
    launched = _route(monkeypatch, lib)
    q, ids, tape = world
    met = Metric.parse(metric)
    qn = (q * q).sum(-1)
    e = _entry() if entry is None else entry
    got = tsearch._rerank_launch(q, ids, tape, met, k, e, qn)
    want = tsearch._rerank_pool_plain(q, ids, tape, met, k, e, qn)
    assert lib.emu_divergence_count() == 0
    return got, want, len(launched)


def _bits(v: torch.Tensor) -> np.ndarray:
    return v.contiguous().view(torch.int32).numpy()


# cosine's tolerance on exact sums: PyTorch's f32 sqrt on the CPU is not
# correctly rounded (it differs from IEEE's in about 0.7% of values by an
# ulp), where the kernel's `__fsqrt_rn` is
COS_TOL = 1e-6

# real-valued data: each version sums a row's d terms in its own order
# (the kernel lane by lane and then by shuffles, PyTorch by its reduction's
# tree), and an f32 sum of d terms carries at most d rounding errors of
# 2^-24 of its terms' magnitude: REAL_TOL x d of the magnitude (l2sq: the
# distance, all terms positive; ip: |q| |r|; cosine: 1, its dot and norms
# relative to theirs)
REAL_TOL = 2.0 ** -23


def _agree(gd, gi, wd, wi, tol) -> None:
    """+inf in the same places, distances within `tol` ([B, k] or a
    number; 0: bit for bit, ids equal), and ids equal except at a near-tie
    (a neighbour in the plain version's list within 2 tol, or the last
    place)."""
    if isinstance(tol, float) and tol == 0.0:
        np.testing.assert_array_equal(gi.numpy(), wi.numpy())
        np.testing.assert_array_equal(_bits(gd), _bits(wd))
        return
    tol = torch.as_tensor(tol, dtype=torch.float64).expand(wd.shape)
    fin = torch.isfinite(wd)
    assert torch.equal(torch.isfinite(gd), fin)
    assert torch.equal(gi == -1, ~fin)
    assert bool(((gd.double() - wd.double()).abs()[fin] <= tol[fin]).all())
    w = wd.double()
    gap = (w[:, 1:] - w[:, :-1]).abs() <= 2 * torch.maximum(tol[:, 1:], tol[:, :-1])
    near = torch.zeros_like(fin)
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    near[:, -1] = True
    assert not bool(((gi != wi) & ~near).any())


def _tol(metric, q, tape, wd) -> object:
    """The tolerance of real-valued data: REAL_TOL x d of the magnitude
    (cosine: 4, for the dot and the two norms the value divides)."""
    d = q.shape[1]
    if metric == "l2sq":
        return REAL_TOL * d * wd.double().abs()
    if metric == "ip":
        return REAL_TOL * d * float(q.norm(dim=1).max()) * float(tape.float().norm(dim=1).max())
    return REAL_TOL * d * 4.0


def _check(lib, monkeypatch, world, k, metric, tol=None, entry=None):
    (gd, gi), (wd, wi), launches = _run(lib, monkeypatch, world, k, metric, entry)
    B = world[1].shape[0]
    assert launches == (1 if B else 0)
    assert gd.dtype == torch.float32 and gi.dtype == torch.int32
    assert gd.shape == gi.shape == wd.shape == wi.shape == (B, k)
    if tol is None:
        tol = COS_TOL if metric == "cosine" else 0.0
    _agree(gd, gi, wd, wi, tol)
    return gd, gi


# (ef, k, B, d): 16-byte loads at d = 128 and 3,080, element loads at d = 6
SHAPES = [
    (10, 10, 3, 128),
    (10, 1, 2, 6),
    (64, 10, 5, 128),
    (64, 64, 2, 6),
    (257, 100, 2, 128),
    (257, 257, 1, 6),
    (64, 10, 1, 3080),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_emulated_rerank_equals_plain(emulated, monkeypatch, metric, dtype):
    for i, (ef, k, B, d) in enumerate(SHAPES):
        world = _world(100 * i + d, B, ef, d, dtype, cap=64 if d > 1000 else 300)
        _check(emulated, monkeypatch, world, k, metric)


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_emulated_rerank_ties_go_to_the_lower_position(emulated, monkeypatch, metric):
    """Equal rows at several pool positions, the higher id first: the
    order is the positions', not the ids'; and one id at two positions."""
    for ef, d in ((10, 128), (64, 6), (257, 128)):
        q, ids, tape = _world(ef + d, 2, ef, d, "f32", kind="ties", neg=0.0)
        ids[:, -1] = ids[:, 0]
        gd, gi = _check(emulated, monkeypatch, (q, ids, tape), ef, metric)
        if metric == "l2sq":
            # the query's pair first, the higher id of it at position 0
            assert int(gi[0, 0]) == int(ids[0, 0]) and int(gi[0, 1]) == int(ids[0, 1])


# (ef, k, metric, tape, data): pools wider than the kernel sorts at a time
# (kRpChunk, 4,096 positions), at d = 6, one query: a second chunk of one
# position and a second round of one output; three chunks, k small; two
# chunks with k past a chunk (two rounds)
WIDE = [(4097, 4097, "l2sq", "f32", "ties"), (8200, 10, "ip", "f32", "ties"),
        (6000, 4200, "cosine", "bf16", "integer")]


@pytest.mark.parametrize("ef,k,metric,dtype,kind", WIDE)
def test_emulated_rerank_wide_pools(emulated, monkeypatch, ef, k, metric, dtype, kind):
    """Pools past a chunk, sorted in chunks and written in rounds: ids and
    distances as the plain version's, equal rows at positions in other
    chunks in the order of their positions, -1 ids among them."""
    world = _world(ef + k, 1, ef, 6, dtype, kind=kind, cap=3000)
    _check(emulated, monkeypatch, world, k, metric)


def test_emulated_rerank_serves_searches_past_a_chunk(emulated, monkeypatch):
    """`HNSWIndex.search` (int8, with its f32 rerank tape) at an ef past a
    chunk, and SQL's HNSW_INDEX_SCAN under `SET hnsw_ef_search` past one,
    with the rerank routed to the emulated kernel: the answers of the
    plain rerank, one launch a search. Integer rows up to 127 make the
    int8 scale 1, so the rerank tape holds the rows exactly and every sum
    is exact."""
    from vss_tpu_torch import Database, HNSWConfig, HNSWIndex, col, const, fn

    rng = np.random.default_rng(22)
    x = rng.integers(-40, 41, (400, 8)).astype(np.float32)
    x[0, 0] = 127.0
    q = x[5:6] + 1.0
    idx = HNSWIndex.build(x, HNSWConfig(dims=8, storage_dtype="int8"), method="native",
                          device="cpu")
    assert idx.vector_scale == 1.0 and idx.rerank_tape is not None
    db = Database(device="cpu")
    db.create_table("t", {"id": np.arange(400, dtype=np.int64), "vec": x})
    db.create_hnsw_index("i", "t", "vec", storage="int8", seed=0)
    db.sql("SET hnsw_ef_search = 4200")

    def searches():
        sql = db.query("t").order_by(fn("array_distance", col("vec"), const(q[0]))).limit(10)
        return idx.search(q, k=10, ef=4200), sql.select("id").execute()["id"]

    (wd, wi), w_sql = searches()
    launched = _route(monkeypatch, emulated)
    monkeypatch.setattr(
        tsearch, "rerank_pool", lambda q, ids, tape, metric, k, entry, q_norms=None:
        tsearch._rerank_launch(q, ids, tape, Metric.parse(metric), k, entry, q_norms))
    (gd, gi), g_sql = searches()
    assert len(launched) == 2 and all(a[8] == 4200 for a in launched)
    np.testing.assert_array_equal(gi.numpy(), wi.numpy())
    np.testing.assert_array_equal(_bits(gd), _bits(wd))
    np.testing.assert_array_equal(np.asarray(g_sql), np.asarray(w_sql))


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_emulated_rerank_real_valued(emulated, monkeypatch, metric):
    for dtype in ("f32", "bf16"):
        for ef, k, B, d in ((64, 10, 4, 128), (64, 64, 2, 6)):
            world = _world(7 + d, B, ef, d, dtype, kind="real")
            wd = tsearch._rerank_pool_plain(world[0], world[1], world[2], Metric.parse(metric),
                                            k, _entry(), (world[0] ** 2).sum(-1))[0]
            _check(emulated, monkeypatch, world, k, metric,
                   tol=_tol(metric, world[0], world[2], wd))


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_emulated_rerank_nan_queries_and_rows(emulated, monkeypatch, metric):
    """A NaN in a query (l2sq and ip: every distance +inf, every id -1;
    cosine: every value 1, as the epilogue's guards give) and in rows."""
    for dtype in ("f32", "bf16"):
        for d in (128, 6):
            q, ids, tape = _world(11 + d, 4, 64, d, dtype)
            q[1, 3] = float("nan")
            for r in (int(ids[0, 2]), int(ids[2, 5]), int(ids[3, 0])):
                if r >= 0:
                    tape[r, 1] = float("nan")
            gd, gi = _check(emulated, monkeypatch, (q, ids, tape), 10, metric)
            if metric != "cosine":
                assert bool((gi[1] == -1).all()) and bool(torch.isinf(gd[1]).all())


def test_emulated_rerank_every_id_minus_one_and_the_empty_graph(emulated, monkeypatch):
    q, ids, tape = _world(13, 3, 64, 128, "f32")
    for metric in ("l2sq", "cosine", "ip"):
        gd, gi = _check(emulated, monkeypatch, (q, torch.full_like(ids, -1), tape), 10, metric)
        assert bool((gi == -1).all()) and bool(torch.isinf(gd).all())
        gd, gi = _check(emulated, monkeypatch, (q, ids, tape), 64, metric, entry=_entry(-1))
        assert bool((gi == -1).all()) and bool(torch.isinf(gd).all())


def test_emulated_rerank_empty_batch(emulated, monkeypatch):
    launched = _route(monkeypatch, emulated)
    q, ids, tape = _world(14, 3, 64, 128, "f32")
    d, i = tsearch._rerank_launch(q[:0], ids[:0], tape, Metric.L2SQ, 10, _entry())
    assert d.shape == i.shape == (0, 10) and not launched


def test_emulated_rerank_refuses_what_it_cannot_take(emulated):
    """ef, k, d or cap out of range, an unknown rerank dtype or metric,
    cosine without norms, no entry: refused, nothing written."""
    fn = emulation.entry(emulated, tsearch._RERANK)
    q, ids, tape = _world(15, 2, 64, 128, "f32")
    qn = (q * q).sum(1)
    e = _entry()
    out_d = torch.full((2, 64), -7.0)
    out_i = torch.full((2, 64), -7, dtype=torch.int32)
    good = dict(qn=qn.data_ptr(), entry=e.data_ptr(), ef=64, cap=300, d=128, rdtype=0, metric=1,
                k=10)

    def call(**kw):
        a = dict(good, **kw)
        return fn(q.data_ptr(), a["qn"], ids.data_ptr(), tape.data_ptr(), a["entry"],
                  out_d.data_ptr(), out_i.data_ptr(), 2, a["ef"], a["cap"], a["d"], a["rdtype"],
                  a["metric"], a["k"], None)

    for bad in (dict(ef=0), dict(ef=-64), dict(k=0), dict(k=65), dict(d=0), dict(d=-128),
                dict(cap=-1), dict(rdtype=2), dict(rdtype=-1), dict(metric=3), dict(qn=None),
                dict(entry=None)):
        assert call(**bad) != 0, bad
    assert bool((out_d == -7).all()) and bool((out_i == -7).all())
    assert call() == 0 and call(qn=None, metric=0) == 0


def test_rerank_kernel_is_registered():
    """The kernel is built from csrc/rerank.cu at first use like the
    others, and its launches are counted under its name."""
    assert csrc.SOURCES["rerank"] == "rerank.cu"
    assert csrc.KERNELS["rerank_pool"] is tsearch._RERANK
    assert tsearch._RERANK.library == "rerank"


def test_rerank_wrapper_refuses_shapes_it_cannot_take():
    """The CUDA route checks shapes before it launches: k outside 1 .. ef,
    queries of another width or dtype, rows of no values, an int8 tape, an
    entry that is not one value, norms of another length. Its only limits
    are these: every ef and d is taken (`test_emulated_rerank_wide_pools`)."""
    q, ids, tape = _world(16, 2, 64, 8, "f32")
    good = dict(q=q, ids=ids, rerank_tape=tape, metric=Metric.L2SQ, k=10, entry=_entry())
    for bad in (dict(k=0), dict(k=65), dict(q=q[:, :4]), dict(q=q.double()),
                dict(q=q[:, :0], rerank_tape=tape[:, :0]), dict(rerank_tape=tape.to(torch.int8)),
                dict(entry=torch.zeros(2)), dict(q_norms=torch.zeros(3))):
        with pytest.raises(ValueError, match="rerank_pool"):
            tsearch._rerank_launch(**dict(good, **bad))


def test_rerank_pool_runs_the_plain_version_on_cpu_tensors(monkeypatch):
    """CPU tensors take `_rerank_pool_plain` and launch nothing; `hnsw_search`
    reranks through `rerank_pool`."""
    def refuse(*a, **k):
        raise AssertionError("launched on CPU tensors")

    monkeypatch.setattr(tsearch._RERANK, "launch", refuse)
    q, ids, tape = _world(17, 3, 64, 16, "f32")
    got = tsearch.rerank_pool(q, ids, tape, "l2sq", 10, _entry())
    want = tsearch._rerank_pool_plain(q, ids, tape, Metric.L2SQ, 10, _entry())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_mutants_fail_a_case(mutant, emulated, monkeypatch):
    """Each mutant differs from the plain version on its case: l2sq by the
    identity on rows of large values a few units from the query (the
    direct difference is exact, the identity's norms are not); ties on
    equal rows; -1 ids where row 0 is the query's own."""
    name, lib = mutant
    if name == "l2sq_dot_identity":
        q, ids, tape = _world(18, 3, 64, 128, "f32")
        tape = tape * 97.0 + 3000.0
        q = tape[ids[:, 1].clamp(min=0).long()] + torch.from_numpy(
            np.random.default_rng(18).integers(-3, 4, (3, 128)).astype(np.float32))
        world, k = (q, ids, tape), 10
    elif name == "ties_to_higher":
        world, k = _world(19, 3, 64, 128, "f32", kind="ties", neg=0.0), 64
    else:
        q, ids, tape = _world(20, 3, 64, 128, "f32", neg=0.3)
        q = tape[0].repeat(3, 1)  # every query is row 0
        ids[ids == 0] = 5
        world, k = (q, ids, tape), 64
    (gd, gi), (wd, wi), _ = _run(lib, monkeypatch, world, k, "l2sq")
    assert not (np.array_equal(gi.numpy(), wi.numpy())
                and np.array_equal(_bits(gd), _bits(wd))), name


@pytest.mark.cuda
def test_rerank_kernel_equals_plain_on_the_card():
    """The kernel built by nvcc from csrc/rerank.cu, on the card, against
    its plain version there, on the integer-valued data above (`_agree`:
    l2sq and ip bit for bit), one launch a call, every tape, metric and
    shape (the wide pools too), and the empty graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    shapes = SHAPES + [(ef, k, 1, 6) for ef, k, *_ in WIDE]
    for dtype in ("f32", "bf16"):
        for metric in ("l2sq", "cosine", "ip"):
            for i, (ef, k, B, d) in enumerate(shapes):
                q, ids, tape = (t.to(dev) for t in _world(100 * i + d, B, ef, d, dtype,
                                                          cap=64 if d > 1000 else 300))
                qn = (q * q).sum(-1)
                met = Metric.parse(metric)
                for e in (0, -1):
                    entry = torch.tensor(e, dtype=torch.int32, device=dev)
                    before = tsearch._RERANK.launches
                    gd, gi = tsearch.rerank_pool(q, ids, tape, met, k, entry, qn)
                    assert tsearch._RERANK.launches == before + 1
                    wd, wi = tsearch._rerank_pool_plain(q, ids, tape, met, k, entry, qn)
                    _agree(gd.cpu(), gi.cpu(), wd.cpu(), wi.cpu(),
                           COS_TOL if metric == "cosine" else 0.0)
