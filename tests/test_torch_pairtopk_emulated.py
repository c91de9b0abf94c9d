"""The CUDA source of the `pairwise_topk` kernel (`csrc/pairtopk.cu`),
compiled with g++ and run on the CPU, against the route it replaces: K4
(`csrc/distance.cu`, compiled the same way) over the tape, then
`_select_k_plain` with the tombstones and NaN read as +inf, then the
stable merge (`ops/topk.py:_chunked_topk`).

There is no nvcc and no card where these tests run; `tests/cuda_emulation.h`
stands in for the CUDA headers and runs a block's threads as cooperative
fibers (a block barrier waits for every thread, a warp's exchanges switch
in step), and its `cp.async` copies land only when their group is awaited.
`tests/emulation.py` turns the `<<<...>>>` launches into calls and the
dynamic shared memory into a pointer, and swaps `csrc/cpasync.cuh` for the
emulation's stand-ins.

The contract is exact: ids equal and distances bit for bit, on real-valued
rows (so that the order of each sum shows), for the three metrics; k = 1,
32, 33, 100 and 256, and k above the tape's rows; tapes whose rows are not
a multiple of 4 or 128; d = 100, which the wrapper pads; query counts that
are not a multiple of the kernel's 128-query tile; duplicate rows in one
slab and across slabs; tombstones, an all-masked tape, a NULL (NaN) query;
zero vectors under cosine; one slab and several (more asked for than the
tape's tiles fill); rows that each come closer than all before them. Two mutants of the kernel (ties to the higher
row, the columns summed in another order) must each fail a case. The
emulation shows what the kernel computes, never how fast, and it cannot
show a missing barrier. One test, marked `cuda`, holds the kernel itself
against the K4 route where a CUDA device is present and skips elsewhere;
on the card (no JAX there, so without this directory's conftest):
`python -m pytest --noconftest -o addopts="" -m cuda
tests/test_torch_pairtopk_emulated.py -q`.
"""
import shutil

import numpy as np
import pytest
import torch

import emulation
import vss_tpu_torch.ops.distance as tdist
import vss_tpu_torch.ops.topk as ttopk
from vss_tpu_torch import csrc
from vss_tpu_torch.utils import pad_to

# the two mutants: rows stored reversed in the composite (ties to the
# higher row, rows still decoded right); each tile's columns summed four
# at a time from the last group of the step to the first
_MUTANTS = {
    "ties_to_the_higher_row": [
        ("| static_cast<unsigned>(row);", "| static_cast<unsigned>(0x7fffffff - row);"),
        ("id = static_cast<int>(e & 0xffffffffull);",
         "id = 0x7fffffff - static_cast<int>(e & 0xffffffffull);"),
    ],
    "columns_in_another_order": [
        ("      for (int kk = 0; kk < kPtCols; kk += 4) {",
         "      for (int kk = kPtCols - 4; kk >= 0; kk -= 4) {"),
    ],
}


def _build(tmp_path_factory, names, edits=()):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    work = tmp_path_factory.mktemp("cuda_emulation")
    emulation.setup(work)
    return emulation.build(work, names, edits)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """libpairtopk and libdistance (K4) built by g++ from csrc/."""
    return _build(tmp_path_factory, ("pairtopk", "distance"))


@pytest.fixture(scope="module", params=sorted(_MUTANTS))
def mutant(request, tmp_path_factory):
    return request.param, _build(tmp_path_factory, ("pairtopk",), _MUTANTS[request.param])[
        "pairtopk"]


def _use(lib, monkeypatch) -> list:
    """Route the kernel's launches to the emulated entry point and its size
    query to the emulated library; returns the list the launches'
    arguments are appended to."""
    fn = emulation.entry(lib, ttopk._PAIRWISE_TOPK)
    launched = []

    def launch(operands, *args):
        rc = fn(*args, None)
        if rc != 0:
            raise RuntimeError(f"pairwise_topk: emulated launch refused ({rc})")
        launched.append(args)

    monkeypatch.setattr(ttopk._PAIRWISE_TOPK, "launch", launch)
    monkeypatch.setattr(csrc, "load", lambda name: {"pairtopk": lib}[name])
    return launched


def _k4(lib):
    """K4 as `dispatch_pairwise` runs it, on the emulated library."""
    fn = emulation.entry(lib, tdist._K4)

    def run(q, x, metric):
        q = csrc.operand(pad_to(q.float(), 1, 16))
        x = csrc.operand(pad_to(x.float(), 1, 16))
        out = torch.empty((q.shape[0], x.shape[0]), dtype=torch.float32)
        assert fn(q.data_ptr(), x.data_ptr(), out.data_ptr(), q.shape[0], x.shape[0],
                  q.shape[1], tdist.METRIC_IDS[tdist.Metric.parse(metric)], None) == 0
        return out

    return run


def _k4_route(k4, q, x, k, metric, valid, chunk=None):
    """The route the kernel replaces: K4 on each chunk, `_select_k_plain`
    (tombstones and NaN as +inf), the stable merge."""
    chunk = chunk or ttopk._choose_chunk(x.shape[0], q.shape[0])
    return ttopk._chunked_topk(
        q, x, valid, k, chunk,
        lambda qq, xs, kk, vs: ttopk._select_k_plain(k4(qq, xs, metric), kk, vs,
                                                     nan_as_inf=True))


def _bits(v: torch.Tensor) -> np.ndarray:
    return v.contiguous().view(torch.int32).numpy()


def _run(libs, monkeypatch, q, x, k, metric, valid=None, slabs=None):
    """(the emulated kernel's output, the K4 route's, launches)."""
    launched = _use(libs["pairtopk"], monkeypatch)
    got = ttopk._pairwise_topk_launch(q, x, k, tdist.Metric.parse(metric), valid, slabs)
    want = _k4_route(_k4(libs["distance"]), q, x, k, metric, valid)
    assert libs["pairtopk"].emu_divergence_count() == 0
    return got, want, len(launched)


def _check(libs, monkeypatch, q, x, k, metric, valid=None, slabs=None):
    (gd, gi), (wd, wi), launches = _run(libs, monkeypatch, q, x, k, metric, valid, slabs)
    assert launches == 1
    assert gd.dtype == torch.float32 and gi.dtype == torch.int32
    assert gd.shape == gi.shape == (q.shape[0], k)
    np.testing.assert_array_equal(gi.numpy(), wi.numpy())
    np.testing.assert_array_equal(_bits(gd), _bits(wd))
    return gd, gi


def _case(seed, nq, nx, d, slabs=1):
    """Real-valued queries and rows from a seed: row 5 repeated in its slab
    and in the last slab, zero rows and a zero query, a NULL (NaN) query,
    a tenth of the rows tombstoned."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    x = rng.normal(size=(nx, d)).astype(np.float32)
    x[min(6, nx - 1)] = x[5 % nx]  # a duplicate in the first slab
    x[nx - 2] = x[5 % nx]  # and in the last
    x[min(7, nx - 1)] = 0.0
    q[min(2, nq - 1)] = 0.0
    q[min(1, nq - 1)] = np.nan
    # queries near rows, so that the k least are not all far
    q[nq // 2:] = x[rng.integers(0, nx, nq - nq // 2)] + rng.normal(
        scale=0.1, size=(nq - nq // 2, d)).astype(np.float32)
    valid = rng.random(nx) > 0.1
    valid[5 % nx] = True
    valid[nx - 2] = True
    return torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(valid)


# nq, nx, d, k, slabs
SHAPES = [
    (37, 1001, 100, 100, 1),  # one slab; d padded; rows not a multiple of 4 or 128
    (37, 1001, 100, 100, 3),  # three slabs (the last short)
    (130, 777, 32, 33, 2),  # two query tiles, the second of 2 queries
    (20, 2500, 16, 256, 4),  # the widest k
    (9, 515, 48, 1, 2),
    (9, 515, 48, 32, 5),  # five slabs of one tile each
    (6, 70, 24, 100, 1),  # k above the rows
    (6, 300, 24, 256, 3),  # k above the rows, over three slabs
    (12, 2600, 16, 8, 10),  # seven slabs of three tiles (ten asked for)
    (40, 3000, 32, 20, 8),
]


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
@pytest.mark.parametrize("nq,nx,d,k,slabs", SHAPES)
def test_emulated_pairwise_topk_equals_k4_route(emulated, monkeypatch, metric, nq, nx, d, k,
                                                slabs):
    q, x, valid = _case(nq * 7 + nx + k, nq, nx, d)
    gd, gi = _check(emulated, monkeypatch, q, x, k, metric, valid, slabs)
    if metric != "cosine":  # the cosine guards map a NaN norm to distance 1
        assert bool((gi[1] == -1).all()) and not bool(torch.isfinite(gd[1]).any())
    assert bool((gi[:, min(k, int(valid.sum())):] == -1).all())


@pytest.mark.parametrize("slabs", [1, 3])
def test_emulated_pairwise_topk_all_masked(emulated, monkeypatch, slabs):
    q, x, _ = _case(3, 5, 400, 16)
    valid = torch.zeros(400, dtype=torch.bool)
    gd, gi = _check(emulated, monkeypatch, q, x, 40, "l2sq", valid, slabs)
    assert bool((gi == -1).all()) and bool(torch.isinf(gd).all())


@pytest.mark.parametrize("k,slabs", [(33, 1), (100, 4), (256, 4)])
def test_emulated_pairwise_topk_many_ties(emulated, monkeypatch, k, slabs):
    """A tape of five distinct rows repeated in every slab: the k least are
    ties but for the row, which decides, across slabs too."""
    rng = np.random.default_rng(k)
    base = rng.normal(size=(5, 32)).astype(np.float32)
    x = torch.from_numpy(base[rng.integers(0, 5, 900)])
    q = torch.from_numpy(rng.normal(size=(11, 32)).astype(np.float32))
    for metric in ("l2sq", "cosine"):
        _check(emulated, monkeypatch, q, x, k, metric, None, slabs)


@pytest.mark.parametrize("k,slabs", [(33, 1), (256, 2)])
def test_emulated_pairwise_topk_rows_ever_closer(emulated, monkeypatch, k, slabs):
    """Each row closer to the queries than every row before it: every
    distance passes its threshold, so every tile's survivors fill the
    lists and each list is cut again and again."""
    rng = np.random.default_rng(5)
    u = rng.normal(size=(1, 16)).astype(np.float32)
    t = np.linspace(50.0, 0.5, 1200, dtype=np.float32)[:, None]
    x = torch.from_numpy(u * t + rng.normal(scale=1e-3, size=(1200, 16)).astype(np.float32))
    q = torch.from_numpy(np.repeat(u * 0.25, 3, axis=0))
    _check(emulated, monkeypatch, q, x, k, "l2sq", None, slabs)


def test_emulated_pairwise_topk_zero_vectors_under_cosine(emulated, monkeypatch):
    """Zero rows and a zero query under cosine: distance 0 for both zero,
    1 for one; ties between the zero rows go to the lower row."""
    q, x, _ = _case(8, 4, 300, 16)
    x[::7] = 0.0
    q[0] = 0.0
    gd, gi = _check(emulated, monkeypatch, q, x, 50, "cosine", None, 2)
    assert gi[0, :5].tolist() == [0, 7, 14, 21, 28] and bool((gd[0, :5] == 0).all())


def test_emulated_pairwise_topk_chunked_merge(emulated, monkeypatch):
    """A caller's `chunk`: the kernel on each chunk (its ids -1 where the
    distance is not finite), merged with the running best, equals the K4
    route over the same chunks and over the whole tape."""
    _use(emulated["pairtopk"], monkeypatch)
    q, x, valid = _case(4, 9, 1100, 24)
    k4 = _k4(emulated["distance"])
    for k in (20, 100):
        got = ttopk._chunked_topk(
            q, x, valid, k, 384,
            lambda qq, xs, kk, vs: ttopk._pairwise_topk_launch(qq, xs, kk, tdist.Metric.L2SQ,
                                                               vs, None))
        for chunk in (384, None):
            want = _k4_route(k4, q, x, k, "l2sq", valid, chunk)
            np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
            np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))


def test_emulated_pairwise_topk_refuses_what_it_cannot_take(emulated):
    """k outside 1 .. 256, slabs outside 1 .. the tape's tiles, d not a
    positive multiple of 16, no workspace, an empty tape: refused, nothing
    written; nq = 0 launches nothing."""
    fn = emulation.entry(emulated["pairtopk"], ttopk._PAIRWISE_TOPK)
    q = torch.zeros((3, 32))
    x = torch.ones((300, 32))
    ws = torch.empty(3 * 3 * 384 * 8 + 3 * 8, dtype=torch.uint8)
    dists = torch.full((3, 300), -7.0)
    ids = torch.full((3, 300), -7, dtype=torch.int32)
    ptrs = [q.data_ptr(), x.data_ptr(), None, dists.data_ptr(), ids.data_ptr()]
    for nx, d, k, slabs, w in ((300, 32, 0, 1, ws), (300, 32, 257, 1, ws),
                               (300, 32, 10, 0, ws), (300, 32, 10, 4, ws),
                               (300, 24, 10, 1, ws), (300, 0, 10, 1, ws),
                               (300, 32, 10, 1, None), (0, 32, 10, 1, ws)):
        assert fn(*ptrs, None if w is None else w.data_ptr(), 3, nx, d, 0, k, slabs,
                  None) != 0
    assert bool((dists == -7).all()) and bool((ids == -7).all())
    assert fn(*ptrs, ws.data_ptr(), 0, 300, 32, 0, 10, 1, None) == 0
    assert bool((ids == -7).all())
    assert fn(*ptrs, ws.data_ptr(), 3, 300, 32, 0, 10, 3, None) == 0
    assert ids.flatten()[:30].tolist() == list(range(10)) * 3  # [3, 10]: all rows equal


@pytest.mark.parametrize("nq,slabs,k", [(512, 66, 100), (37, 3, 1), (130, 2, 256), (1, 1, 33)])
def test_workspace_holds_the_lists_and_bounds(emulated, nq, slabs, k):
    """Each query's list in each slab (k rounded up to 32, plus two tiles
    of 128) and its bound, 8 bytes an entry; -1 for arguments refused."""
    size = emulated["pairtopk"].vss_pairwise_topk_workspace_bytes
    size.restype = csrc.I64
    size.argtypes = [csrc.I32] * 3
    assert size(nq, slabs, k) == (nq * slabs * ((k + 31) // 32 * 32 + 256) + nq) * 8
    assert size(nq, slabs, 0) == size(nq, 0, k) == size(nq, slabs, 257) == -1


# each mutant's cases (nq, nx, d, k, slabs, kind): "ties" a row repeated
# in two slabs only, "normal" real-valued rows
_MUTANT_CASES = {
    "ties_to_the_higher_row": [(4, 600, 16, 40, 2, "ties"), (4, 600, 16, 40, 1, "ties")],
    "columns_in_another_order": [(8, 600, 48, 33, 2, "normal"), (8, 600, 100, 100, 1, "normal")],
}


def test_mutants_fail_a_case(emulated, mutant, monkeypatch):
    """Each mutant differs from the K4 route on each of its cases: the
    reversed ties where a row repeats in another slab (and in one slab),
    the other column order on real-valued rows."""
    name, lib = mutant
    k4 = _k4(emulated["distance"])
    for nq, nx, d, k, slabs, kind in _MUTANT_CASES[name]:
        q, x, _ = _case(nx + k, nq, nx, d)
        q = q[2:] if kind == "ties" else q  # no NULL or zero query
        if kind == "ties":
            x[500] = x[30]  # slab 0 and slab 1 (of 2)
            q[:] = x[30] + 0.01
        _use(lib, monkeypatch)
        gd, gi = ttopk._pairwise_topk_launch(q, x, k, tdist.Metric.L2SQ, None, slabs)
        wd, wi = _k4_route(k4, q, x, k, "l2sq", None)
        assert not (np.array_equal(gi.numpy(), wi.numpy())
                    and np.array_equal(_bits(gd), _bits(wd))), (name, nq, nx, d, k, slabs)


def test_pairwise_topk_on_cpu_runs_the_plain_version(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel launched for CPU tensors")

    monkeypatch.setattr(ttopk._PAIRWISE_TOPK, "launch", refuse)
    q, x, valid = _case(2, 6, 700, 24)
    for k in (5, 100):
        gd, gi = ttopk.pairwise_topk(q, x, k, "ip", valid)
        wd, wi = ttopk._pairwise_topk_plain(q, x, k, "ip", valid, chunk=256)
        np.testing.assert_array_equal(gi.numpy(), wi.numpy())
        np.testing.assert_array_equal(_bits(gd), _bits(wd))


def test_chunked_oracle_dispatch_on_device_and_k(monkeypatch):
    """Off the CPU, the chunked path makes one `pairwise_topk` call over the
    whole tape for k <= SELECT_K_MAX (one a chunk where the caller passes
    `chunk`), and K4 blocks through `select_k` above it; on the CPU it runs
    K4's plain version and `select_k` a chunk. A meta tensor stands in for
    a CUDA one."""
    calls = []

    def fake_topk(q, x, k, metric, valid=None):
        calls.append(("pairwise_topk", x.shape[0], k))
        return (torch.full((q.shape[0], k), float("inf"), device=q.device),
                torch.full((q.shape[0], k), -1, dtype=torch.int32, device=q.device))

    def fake_k4(q, x, metric):
        calls.append(("K4", x.shape[0]))
        return torch.empty((q.shape[0], x.shape[0]), device=q.device)

    def fake_select(d, k, valid=None, nan_as_inf=False):
        calls.append(("select_k", d.shape[1], k))
        return (torch.full((d.shape[0], k), float("inf"), device=d.device),
                torch.zeros((d.shape[0], k), dtype=torch.int32, device=d.device))

    monkeypatch.setattr(ttopk, "pairwise_topk", fake_topk)
    monkeypatch.setattr(ttopk, "dispatch_pairwise", fake_k4)
    monkeypatch.setattr(ttopk, "select_k", fake_select)
    q = torch.empty((4, 16), device="meta")
    x = torch.empty((1000, 16), device="meta")
    valid = torch.ones(1000, dtype=torch.bool, device="meta")
    ttopk._bruteforce_chunked(q, x, valid, 100, tdist.Metric.L2SQ, None)
    assert calls == [("pairwise_topk", 1000, 100)]
    calls.clear()
    ttopk._bruteforce_chunked(q, x, valid, 256, tdist.Metric.L2SQ, 400)
    assert calls == [("pairwise_topk", 400, 256), ("pairwise_topk", 400, 256),
                     ("pairwise_topk", 200, 200)]
    calls.clear()
    ttopk._bruteforce_chunked(q, x, valid, 300, tdist.Metric.L2SQ, None)
    assert calls == [("K4", 1000), ("select_k", 1000, 300)]


def test_pairwise_topk_kernel_is_registered():
    """The kernel is built from csrc/pairtopk.cu at first use like the
    others (its headers among the build's), and its launches are counted
    under its name."""
    assert csrc.SOURCES["pairtopk"] == "pairtopk.cu"
    assert {"selectk.cuh", "cpasync.cuh"} <= set(csrc._HEADERS)
    assert csrc.KERNELS["pairwise_topk"] is ttopk._PAIRWISE_TOPK
    assert ttopk._PAIRWISE_TOPK.library == "pairtopk"


def test_pairwise_topk_wrapper_refuses_shapes_it_cannot_take():
    q, x, _ = _case(6, 3, 200, 16)
    for bad in (dict(q=q, x=x, k=257), dict(q=q, x=x[:, :8], k=3), dict(q=q[0], x=x, k=3),
                dict(q=q, x=x, k=3, valid=torch.ones(199, dtype=torch.bool))):
        with pytest.raises(ValueError, match="pairwise_topk"):
            ttopk._pairwise_topk_launch(bad["q"], bad["x"], bad["k"], tdist.Metric.L2SQ,
                                        bad.get("valid"), None)


@pytest.mark.parametrize("nq,nx,want", [
    (512, 1_000_000, 66),  # the main shape: 4 query tiles x 66 slabs = 264 blocks
    (512, 524_288, 66),
    (2048, 1_000_000, 17),
    (64, 1_000_000, 264),
    (512, 300, 3),  # a slab a tile
    (1, 100, 1),
])
def test_pairwise_topk_slabs_fill_the_card(nq, nx, want):
    assert ttopk._pairwise_topk_slabs(nq, nx) == want


@pytest.mark.cuda
def test_pairwise_topk_kernel_equals_k4_route_on_the_card():
    """The kernel built by nvcc from csrc/pairtopk.cu, on the card, against
    the route it replaces there (K4, then the select_k kernel, then the
    stable merge) on the same tensors: ids equal and distances bit for
    bit, every case of the emulated tests and a 512 x 200,000 x 128 tape,
    one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cases = [(nq, nx, d, k, slabs) for nq, nx, d, k, slabs in SHAPES]
    cases += [(512, 200_000, 128, 100, None), (512, 200_000, 128, 256, None)]
    for nq, nx, d, k, slabs in cases:
        q, x, valid = (t.to(dev) for t in _case(nq * 7 + nx + k, nq, nx, d))
        for metric in ("l2sq", "cosine", "ip"):
            before = ttopk._PAIRWISE_TOPK.launches
            gd, gi = ttopk._pairwise_topk_launch(q, x, k, tdist.Metric.parse(metric), valid,
                                                 slabs)
            assert ttopk._PAIRWISE_TOPK.launches == before + 1
            wd, wi = ttopk._chunked_topk(
                q, x, valid, k, ttopk._choose_chunk(nx, nq),
                lambda qq, xs, kk, vs: ttopk.select_k(
                    tdist.dispatch_pairwise(qq, xs, metric), kk, vs, nan_as_inf=True))
            assert torch.equal(gi, wi), (nq, nx, d, k, slabs, metric)
            assert torch.equal(gd.view(torch.int32), wd.view(torch.int32)), (nq, nx, d, k)
