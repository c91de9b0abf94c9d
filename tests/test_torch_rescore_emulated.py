"""The CUDA source of the `rescore_topk` kernel (`csrc/rescore.cu`: phases B
and C of `scan_topk`), compiled with g++ and run on the CPU, against its
plain version `_rescore_plain` (over query chunks, `_rescore_chunks`).

There is no nvcc and no card where these tests run, so the kernel itself
is held against the plain version only on the card (`chip_smoke.py`,
`check_rescore`, and the test marked `cuda` below). What runs here is its
C++: `tests/cuda_emulation.h` stands in for the CUDA headers and runs a
block's threads as cooperative fibers that switch at every barrier and
warp exchange; `tests/emulation.py` turns the `<<<...>>>` launch into a
call and the dynamic shared memory into a pointer, and changes nothing
else.

The contract is exact on integer-valued data, where every f32 sum is
exact whatever its order: ids equal and distances bit for bit (cosine
within 1e-6, `COS_TOL`, ids equal up to near-ties), for int8,
bf16 and f32 tapes, with an f32 or bf16 rerank tape and without one, every
metric; k in {1, 10, 32, 100, 128} with the m that `scan_topk` derives;
keep in {1, k + 2, 2k, 256}; -1 segments, a ragged last sub-segment (the
tape's rows not a multiple of 32), invalid rows, ties in both phases, a
NaN query, zero rows and a zero query under cosine; nq in {1, 37}, d in
{100, 128} (16-byte loads and element loads), one block a query and a
query split over several. Two mutants (phase C's ties to the higher pool
position; a -1 segment scored as segment 0) must each fail a case. The
emulation shows what the kernel computes, never how fast, and it cannot
show a missing barrier. One test, marked `cuda`, holds the kernel itself
against the plain version where a CUDA device is present and skips
elsewhere; on the card (no JAX there, so without this directory's
conftest): `python -m pytest --noconftest -o addopts="" -m cuda
tests/test_torch_rescore_emulated.py -q`.
"""
import shutil

import numpy as np
import pytest
import torch

import emulation
import vss_tpu_torch.ops.scan as tscan
from vss_tpu_torch import csrc
from vss_tpu_torch.ops.distance import Metric

# the two mutants: phase C's composite with the pool position reversed
# (ties to the higher position, positions still decoded right); a -1
# segment clamped to segment 0 and not masked
_MUTANTS = {
    "phase_c_ties_to_higher": [
        ("static_cast<unsigned>(i)", "static_cast<unsigned>(kRsPool - 1 - i)"),
        ("const int slot = static_cast<int>(s.buf[j] & 0xffffffffull);",
         "const int slot = kRsPool - 1 - static_cast<int>(s.buf[j] & 0xffffffffull);"),
    ],
    "minus_one_segment_scored": [
        ("return seg < 0 || row >= nx ? -1 : row;", "return row >= nx ? -1 : row;"),
    ],
}

_DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}

# rows of the test tape: 128 whole sub-segments and a ragged 129th of 13
_NX = 4109


def _build(tmp_path_factory, edits=()):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    work = tmp_path_factory.mktemp("cuda_emulation")
    emulation.setup(work)
    return emulation.build(work, ("rescore",), edits)["rescore"]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """librescore built by g++ from csrc/rescore.cu."""
    return _build(tmp_path_factory)


@pytest.fixture(scope="module", params=sorted(_MUTANTS))
def mutant(request, tmp_path_factory):
    return request.param, _build(tmp_path_factory, _MUTANTS[request.param])


def _route(monkeypatch, lib) -> list:
    """Route the kernel's launches to the emulated library; returns the
    list each launch's arguments are appended to."""
    fn = emulation.entry(lib, tscan._RESCORE)
    launched = []

    def launch(operands, *args):
        rc = fn(*args, None)
        if rc != 0:
            raise RuntimeError(f"rescore_topk: emulated launch refused ({rc})")
        launched.append(args)

    monkeypatch.setattr(tscan._RESCORE, "launch", launch)
    return launched


def _world(seed, nq, d, dtype, rr_dtype, kind="normal", nx=_NX):
    """(q [nq, d] f32, tape [nx, d], x_norms [nx], valid [nx], rerank tape
    or None), every value an integer small enough that each f32 sum of
    either version is exact. Queries lie near tape rows; a tenth of the
    rows are invalid. kind "ties": each row three times and queries of
    small integers, so that distances tie in both phases."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        x = np.repeat(rng.integers(-2, 3, (nx // 3 + 1, d)), 3, 0)[:nx].astype(np.float32)
        q = rng.integers(-2, 3, (nq, d)).astype(np.float32)
        r = x
    else:
        hi = 127 if dtype == "int8" else 40
        x = rng.integers(-hi, hi + 1, (nx, d)).astype(np.float32)
        q = (x[rng.integers(0, nx, nq)] + rng.integers(-5, 6, (nq, d))).astype(np.float32)
        r = x + rng.integers(-3, 4, x.shape).astype(np.float32)
    tape = torch.from_numpy(x).to(_DTYPES[dtype])
    xn = (tape.float() ** 2).sum(1)
    valid = torch.from_numpy(rng.random(nx) > 0.1)
    rr = None if rr_dtype is None else torch.from_numpy(r).to(_DTYPES[rr_dtype])
    return torch.from_numpy(q), tape, xn, valid, rr


def _segs(seed, nq, keep, nx=_NX, neg=0.1):
    """[nq, keep] int32 sub-segment ids: distinct segments of the tape in
    random order (the ragged last one first in query 0), -1 past the
    tape's segments and at a share `neg` of places elsewhere."""
    rng = np.random.default_rng(seed)
    nsub = -(-nx // 32)
    out = np.full((nq, keep), -1, np.int32)
    for b in range(nq):
        take = min(keep, nsub)
        out[b, :take] = rng.choice(nsub, take, replace=False)
    out[rng.random((nq, keep)) < neg] = -1
    out[0, 0] = nsub - 1
    return torch.from_numpy(out)


def _m(k, keep, rr) -> int:
    """scan_topk's phase-B pool."""
    return min(max(2 * k, k + 6), keep * 32) if rr is not None else k


def _run(lib, monkeypatch, world, segs, k, metric, splits=None):
    """(the emulated kernel's (dists, ids), the plain version's, launches)."""
    launched = _route(monkeypatch, lib)
    q, tape, xn, valid, rr = world
    m, metric = _m(k, segs.shape[1], rr), Metric.parse(metric)
    got = tscan._rescore_launch(q, segs, tape, xn, valid, rr, m, k, metric, splits)
    want = tscan._rescore_chunks(q, segs, tape, xn, valid, rr, m, k, metric)
    assert lib.emu_divergence_count() == 0
    return got, want, len(launched)


def _bits(v: torch.Tensor) -> np.ndarray:
    return v.contiguous().view(torch.int32).numpy()


# cosine's tolerance: its sums are exact too, but PyTorch's f32 sqrt on
# the CPU is not correctly rounded (it differs from IEEE's in about 0.7%
# of values by an ulp), where the kernel's `__fsqrt_rn` is
COS_TOL = 1e-6


def _agree(gd, gi, wd, wi, metric) -> None:
    """l2sq and ip: ids equal and distances bit for bit. cosine: +inf in
    the same places, distances within COS_TOL, and ids equal except at a
    near-tie (a neighbour in the plain version's list within 2 COS_TOL, or
    the last place)."""
    if metric != "cosine":
        np.testing.assert_array_equal(gi.numpy(), wi.numpy())
        np.testing.assert_array_equal(_bits(gd), _bits(wd))
        return
    fin = torch.isfinite(wd)
    assert torch.equal(torch.isfinite(gd), fin)
    assert float((gd[fin] - wd[fin]).abs().max()) <= COS_TOL if bool(fin.any()) else True
    gap = (wd[:, 1:] - wd[:, :-1]).abs() <= 2 * COS_TOL
    near = torch.zeros_like(fin)
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    near[:, -1] = True
    assert not bool(((gi != wi) & ~near).any())


def _check(lib, monkeypatch, world, segs, k, metric, splits=None):
    (gd, gi), (wd, wi), launches = _run(lib, monkeypatch, world, segs, k, metric, splits)
    nq = segs.shape[0]
    assert launches == 1
    assert gd.dtype == torch.float32 and gi.dtype == torch.int32
    assert gd.shape == gi.shape == wd.shape == wi.shape == (nq, k)
    _agree(gd, gi, wd, wi, metric)
    return gd, gi


# k, keep, nq, d, splits (None: the wrapper's choice); keep runs over
# {1, k + 2, 2k, 256}
SHAPES = [
    (1, 1, 1, 128, None),
    (1, 3, 37, 128, None),
    (10, 12, 3, 100, None),
    (10, 20, 1, 100, None),  # one query: split over 2 blocks
    (10, 256, 1, 128, 3),
    (32, 1, 3, 128, None),  # 32 candidates: m capped at keep * 32
    (32, 64, 1, 100, 1),
    (100, 200, 2, 128, None),  # scan_search's k=100 call, each query split
    (100, 1, 2, 100, None),  # fewer candidates than k: +inf, -1 past them
    (128, 130, 1, 128, None),
    (128, 256, 1, 128, 2),
]

# the shapes on which cosine and ip run as well: the metric enters only the
# epilogues, so one shape of each kind (element loads, m capped, a query
# split, k = 128)
METRIC_SHAPES = [SHAPES[i] for i in (2, 5, 7, 9)]


@pytest.mark.parametrize("rr_dtype", ["f32", "bf16", None])
@pytest.mark.parametrize("dtype", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_emulated_rescore_equals_plain(emulated, monkeypatch, metric, dtype, rr_dtype):
    for i, (k, keep, nq, d, splits) in enumerate(SHAPES):
        if metric != "l2sq" and SHAPES[i] not in METRIC_SHAPES:
            continue
        world = _world(100 * i + d, nq, d, dtype, rr_dtype)
        _check(emulated, monkeypatch, world, _segs(i, nq, keep), k, metric, splits)


@pytest.mark.parametrize("rr_dtype", ["f32", None])
@pytest.mark.parametrize("k,keep,splits", [(10, 20, 1), (10, 20, 3), (100, 200, 1),
                                           (100, 200, 4)])
def test_emulated_rescore_ties(emulated, monkeypatch, k, keep, splits, rr_dtype):
    """Rows that repeat (each three times) and queries of small integers:
    phase B's ties to the lower candidate position, phase C's to the lower
    pool position (not the lower row id)."""
    world = _world(k + splits, 3, 16, "int8", rr_dtype, kind="ties")
    for metric in ("l2sq", "cosine", "ip"):
        _check(emulated, monkeypatch, world, _segs(k, 3, keep), k, metric, splits)


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_emulated_rescore_nan_and_zero_queries(emulated, monkeypatch, metric):
    """A NaN query (l2sq and ip: every distance +inf, every id -1; cosine:
    every value 1), a zero query and zero rows (cosine's guards)."""
    q, tape, xn, valid, rr = _world(5, 4, 32, "int8", "f32")
    q[1, 3] = float("nan")
    q[2] = 0.0
    tape[:40] = 0
    rr[:40] = 0.0
    xn = (tape.float() ** 2).sum(1)
    segs = _segs(6, 4, 24)
    segs[:, 1] = 0  # the zero rows in every query's candidates
    segs[:, 2] = 1
    for k, splits in ((10, 1), (10, 3), (33, 1)):
        for r in (rr, None):
            gd, gi = _check(emulated, monkeypatch, (q, tape, xn, valid, r), segs, k, metric,
                            splits)
            if metric != "cosine":
                assert bool((gi[1] == -1).all()) and bool(torch.isinf(gd[1]).all())


def test_emulated_rescore_every_segment_padding_or_invalid(emulated, monkeypatch):
    q, tape, xn, valid, rr = _world(7, 3, 32, "int8", "f32")
    for segs, v in ((torch.full((3, 12), -1, dtype=torch.int32), valid),
                    (_segs(8, 3, 12), torch.zeros_like(valid))):
        for k in (1, 10, 33):
            gd, gi = _check(emulated, monkeypatch, (q, tape, xn, v, rr), segs, k, "l2sq")
            assert bool((gi == -1).all()) and bool(torch.isinf(gd).all())


def test_emulated_rescore_empty_batch(emulated, monkeypatch):
    launched = _route(monkeypatch, emulated)
    q, tape, xn, valid, rr = _world(9, 3, 32, "int8", "f32")
    d, i = tscan.rescore_topk(q[:0], _segs(9, 3, 12)[:0], tape, xn, valid, rr, 20, 10, "l2sq")
    assert d.shape == i.shape == (0, 10) and not launched


def test_emulated_rescore_refuses_what_it_cannot_take(emulated):
    """keep, m, k or splits out of range, splits > 1 without a workspace,
    an unknown dtype, rerank dtype or metric, a rerank dtype without a
    tape: refused, nothing written."""
    fn = emulation.entry(emulated, tscan._RESCORE)
    q, tape, xn, valid, rr = _world(10, 2, 32, "int8", "f32")
    segs = _segs(10, 2, 12)
    qn = (q * q).sum(1)
    vb = valid.to(torch.uint8)
    out_d = torch.full((2, 300), -7.0)
    out_i = torch.full((2, 300), -7, dtype=torch.int32)
    ws = torch.empty(2 * 12 * 256 * 8 + 8, dtype=torch.uint8)
    ptrs = [t.data_ptr() for t in (q, qn, segs, tape, xn, vb)]
    good = dict(rerank=rr.data_ptr(), ws=None, keep=12, dtype=2, rdtype=0, metric=0, m=20, k=10,
                splits=1)

    def call(**kw):
        a = dict(good, **kw)
        return fn(*ptrs, a["rerank"], out_d.data_ptr(), out_i.data_ptr(), a["ws"], 2, a["keep"],
                  _NX, 32, a["dtype"], a["rdtype"], a["metric"], a["m"], a["k"], a["splits"], None)

    for bad in (dict(keep=0), dict(m=0), dict(m=257), dict(k=0), dict(k=257), dict(splits=0),
                dict(splits=13), dict(splits=2), dict(dtype=3), dict(rdtype=2),
                dict(rdtype=-1), dict(rerank=None), dict(metric=3)):
        assert call(**bad) != 0, bad
    assert bool((out_d == -7).all()) and bool((out_i == -7).all())
    assert call(ws=ws.data_ptr(), splits=2) == 0


def test_rescore_kernel_is_registered():
    """The kernel is built from csrc/rescore.cu at first use like the
    others, and its launches are counted under its name."""
    assert csrc.SOURCES["rescore"] == "rescore.cu"
    assert csrc.KERNELS["rescore_topk"] is tscan._RESCORE
    assert tscan._RESCORE.library == "rescore"


def test_rescore_wrapper_refuses_shapes_it_cannot_take():
    q, tape, xn, valid, rr = _world(11, 2, 32, "int8", "f32")
    segs = _segs(11, 2, 12)
    good = dict(q=q, segs=segs, tape=tape, x_norms=xn, valid=valid, rerank_tape=rr, m=20, k=10,
                metric=Metric.L2SQ)
    for bad in (dict(m=257), dict(k=0), dict(q=q[:, :8]), dict(x_norms=xn[:5]),
                dict(valid=valid[:5]), dict(rerank_tape=rr[:, :8]),
                dict(rerank_tape=rr.to(torch.int8)), dict(segs=segs[:1])):
        with pytest.raises(ValueError, match="rescore_topk"):
            tscan._rescore_launch(**dict(good, **bad))


def test_mutants_fail_a_case(mutant, emulated, monkeypatch):
    """Each mutant differs from the plain version on its case: phase C's
    ties on repeated rows; a -1 segment where segment 0 holds the query's
    own row."""
    name, lib = mutant
    if name == "phase_c_ties_to_higher":
        world = _world(3, 3, 16, "int8", "f32", kind="ties")
        segs = _segs(3, 3, 20)
    else:
        world = _world(4, 3, 32, "int8", None)
        segs = _segs(4, 3, 20)
        segs[segs == 0] = 5
        segs[:, 7] = -1
        world[3][:] = True
        world[0][:] = world[1][3].float()  # each query is row 3, in segment 0
    (gd, gi), (wd, wi), _ = _run(lib, monkeypatch, world, segs, 10, "l2sq")
    assert not (np.array_equal(gi.numpy(), wi.numpy())
                and np.array_equal(_bits(gd), _bits(wd))), name


@pytest.mark.cuda
def test_rescore_kernel_equals_plain_on_the_card():
    """The kernel built by nvcc from csrc/rescore.cu, on the card, against
    its plain version there, on the integer-valued data above (`_agree`:
    l2sq and ip bit for bit), one launch a call, every tape, rerank tape,
    metric and shape, both layouts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for dtype in ("int8", "bf16", "f32"):
        for rr_dtype in ("f32", "bf16", None):
            for metric in ("l2sq", "cosine", "ip"):
                for i, (k, keep, nq, d, splits) in enumerate(SHAPES):
                    if keep * 32 < k:
                        continue  # select_k on the card takes k <= its columns
                    q, tape, xn, valid, rr = (None if t is None else t.to(dev) for t in _world(
                        100 * i + d, nq, d, dtype, rr_dtype))
                    segs = _segs(i, nq, keep).to(dev)
                    m, met = _m(k, keep, rr), Metric.parse(metric)
                    before = tscan._RESCORE.launches
                    gd, gi = tscan._rescore_launch(q, segs, tape, xn, valid, rr, m, k, met,
                                                   splits)
                    assert tscan._RESCORE.launches == before + 1
                    wd, wi = tscan._rescore_chunks(q, segs, tape, xn, valid, rr, m, k, met)
                    _agree(gd.cpu(), gi.cpu(), wd.cpu(), wi.cpu(), metric)
