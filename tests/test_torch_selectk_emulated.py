"""The CUDA source of the `select_k` kernel (`csrc/selectk.cu`), compiled
with g++ and run on the CPU, against its plain version `_select_k_plain`
(`_select_min_k_plain` after the mask and NaN options).

There is no nvcc and no card where these tests run, so the kernel itself
is held against the plain version only on the card (`chip_smoke.py`,
`check_select_k`). What runs here is its C++: `tests/cuda_emulation.h`
stands in for the CUDA headers and runs a block's threads as cooperative
fibers that switch at every barrier and warp exchange; `tests/emulation.py`
turns the `<<<...>>>` launch into a call and the dynamic shared memory
into a pointer, and changes nothing else.

The contract is exact: values bit for bit (-0 stays -0, a NaN keeps its
bits) and positions equal, in both of `_select_min_k_plain`'s orders (k
<= 32: argmin passes; k > 32: a stable sort), with one block a row and
with a row split over several blocks whose lists the last block merges;
with the column mask and NaN read as +inf; on rows with ties, +-0, +-inf,
NaN (some and all), rows of +inf, k = C, k = 1, k = 32 / 33 / 256, C = 1
and R = 0. Two mutants of the kernel (ties in reverse position order, NaN
ranked in the other order's place) must each fail a case. The emulation
shows what the kernel computes, never how fast, and it cannot show a
missing barrier. One test, marked `cuda`, holds the kernel itself against
the plain version where a CUDA device is present and skips elsewhere; on
the card (no JAX there, so without this directory's conftest):
`python -m pytest --noconftest -o addopts="" -m cuda
tests/test_torch_selectk_emulated.py -q`.
"""
import shutil

import numpy as np
import pytest
import torch

import emulation
import vss_tpu_torch.ops.topk as ttopk
from vss_tpu_torch import csrc

# the two mutants: positions stored reversed in the composite (ties in
# reverse position order, positions still decoded right); NaN given the
# other order's key
_MUTANTS = {
    "ties_reversed": [
        ("static_cast<unsigned>(p);", "static_cast<unsigned>(0x7fffffff - p);"),
        ("int p = static_cast<int>(c & 0xffffffffull);",
         "int p = 0x7fffffff - static_cast<int>(c & 0xffffffffull);"),
    ],
    "nan_other_order": [("order_key(r.v, iter_order)", "order_key(r.v, !iter_order)")],
}


def _build(tmp_path_factory, edits=()):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    work = tmp_path_factory.mktemp("cuda_emulation")
    emulation.setup(work)
    return emulation.build(work, ("selectk",), edits)["selectk"]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """libselectk built by g++ from csrc/selectk.cu."""
    return _build(tmp_path_factory)


@pytest.fixture(scope="module", params=sorted(_MUTANTS))
def mutant(request, tmp_path_factory):
    return request.param, _build(tmp_path_factory, _MUTANTS[request.param])


def _use(lib, monkeypatch) -> list:
    """Route the kernel's launches to the emulated entry point; returns the
    list the launches' arguments are appended to."""
    fn = emulation.entry(lib, ttopk._SELECT_K)
    launched = []

    def launch(operands, *args):
        rc = fn(*args, None)
        if rc != 0:
            raise RuntimeError(f"select_k: emulated launch refused ({rc})")
        launched.append(args)

    monkeypatch.setattr(ttopk._SELECT_K, "launch", launch)
    return launched


def _bits(v: torch.Tensor) -> np.ndarray:
    return v.contiguous().view(torch.int32).numpy()


def _run(lib, monkeypatch, d, k, valid=None, nan_as_inf=False, splits=None):
    """(the emulated kernel's output, the plain version's, launches)."""
    launched = _use(lib, monkeypatch)
    got = ttopk._select_k_launch(d, k, valid, nan_as_inf, splits)
    want = ttopk._select_k_plain(d, k, valid, nan_as_inf)
    assert lib.emu_divergence_count() == 0
    return got, want, len(launched)


def _check(lib, monkeypatch, d, k, valid=None, nan_as_inf=False, splits=None):
    (gv, gp), (wv, wp), launches = _run(lib, monkeypatch, d, k, valid, nan_as_inf, splits)
    R = d.shape[0]
    assert launches == int(R > 0 and k > 0)
    assert gv.dtype == torch.float32 and gp.dtype == torch.int32
    assert gv.shape == gp.shape == (R, k)
    np.testing.assert_array_equal(gp.numpy(), wp.numpy())
    np.testing.assert_array_equal(_bits(gv), _bits(wv))
    return gv, gp


def _rows(seed, R, C, kind="normal"):
    """f32 [R, C] rows: "normal" N(0, 1); "ties" small integers, many
    equal; "edge" small integers with +-0, +-inf and NaN (the NaNs of
    both signs) sprinkled over them, a row all NaN, a row all +inf, a row
    of fewer non-+inf values than any k here."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return torch.from_numpy(rng.normal(size=(R, C)).astype(np.float32))
    x = rng.integers(-3, 4, (R, C)).astype(np.float32)
    if kind == "edge":
        u = rng.random((R, C))
        x[u < 0.1] = -0.0
        x[(u >= 0.1) & (u < 0.2)] = 0.0
        x[(u >= 0.2) & (u < 0.25)] = np.inf
        x[(u >= 0.25) & (u < 0.28)] = -np.inf
        x[(u >= 0.28) & (u < 0.32)] = np.nan
        x[(u >= 0.32) & (u < 0.33)] = -np.float32(np.nan)  # sign bit set
        if R >= 4:
            x[1] = np.nan
            x[2] = np.inf
            x[3] = np.inf
            x[3, rng.choice(C, min(C, 3), replace=False)] = -1.0
    return torch.from_numpy(x)


# R, C, k, splits (None: the wrapper's choice)
SHAPES = [
    (6, 48, 12, None),  # scan_search's second selection at k=10
    (4, 448, 112, None),  # ... at k=100
    (5, 384, 20, None),  # the scan's rescore at k=10
    (3, 3584, 200, None),  # ... at k=100
    (4, 1280, 10, None),  # the winnow's rescore
    (3, 7813, 12, None),  # the scan's first selection, one block a row
    (3, 7813, 112, 3),  # ... split over three blocks
    (2, 5000, 4, 4),  # the pivot seeding's k, split
    (4, 3000, 32, 5),
    (4, 3000, 33, 2),
    (2, 2500, 256, 2),
    (3, 700, 256, None),
]


@pytest.mark.parametrize("kind", ["normal", "ties", "edge"])
@pytest.mark.parametrize("R,C,k,splits", SHAPES)
def test_emulated_select_k_equals_plain(emulated, monkeypatch, kind, R, C, k, splits):
    d = _rows(R * 131 + C + k, R, C, kind)
    _check(emulated, monkeypatch, d, k, splits=splits)


@pytest.mark.parametrize("k", [1, 10, 32, 33, 100])
@pytest.mark.parametrize("splits", [1, 3])
def test_emulated_select_k_mask_and_nan_options(emulated, monkeypatch, k, splits):
    """The chunked oracle's options: masked columns and NaN read as +inf
    (and come back as +inf), alone and together."""
    d = _rows(k + splits, 4, 2600, "edge")
    valid = torch.from_numpy(np.random.default_rng(k).random(2600) > 0.3)
    valid[:5] = False
    _check(emulated, monkeypatch, d, k, valid=valid, splits=splits)
    _check(emulated, monkeypatch, d, k, nan_as_inf=True, splits=splits)
    gv, _ = _check(emulated, monkeypatch, d, k, valid=valid, nan_as_inf=True, splits=splits)
    assert not bool(gv.isnan().any())


def test_emulated_select_k_everything_masked(emulated, monkeypatch):
    d = _rows(1, 3, 600, "normal")
    valid = torch.zeros(600, dtype=torch.bool)
    for k in (5, 40):
        gv, gp = _check(emulated, monkeypatch, d, k, valid=valid, splits=2)
        assert bool(torch.isinf(gv).all())


@pytest.mark.parametrize("R,C,k,splits", [
    (3, 1, 1, 1),  # C = 1
    (4, 40, 40, 1),  # k = C, k > 32
    (4, 20, 20, 1),  # k = C, k <= 32
    (4, 300, 300 // 2, 7),  # many splits, each shorter than k
    (2, 9, 9, 9),  # a split a column
    (5, 77, 1, 1),  # k = 1
    (0, 50, 10, 1),  # R = 0: nothing launched
    (3, 50, 0, 1),  # k = 0: nothing launched
])
@pytest.mark.parametrize("kind", ["ties", "edge"])
def test_emulated_select_k_edge_shapes(emulated, monkeypatch, R, C, k, splits, kind):
    _check(emulated, monkeypatch, _rows(C + k, R, C, kind), k, splits=splits)


def test_emulated_select_k_signed_zeros_and_infinities(emulated, monkeypatch):
    """Rows of -0, +0, -inf and +inf only, in both orders: zeros equal and
    in position order, each returned with its own sign."""
    vals = np.array([-0.0, 0.0, np.inf, -np.inf], np.float32)
    d = torch.from_numpy(vals[np.random.default_rng(2).integers(0, 4, (4, 90))])
    for k in (3, 32, 33, 90):
        gv, _ = _check(emulated, monkeypatch, d, k, splits=2)
    assert bool(torch.signbit(gv[gv == 0]).any()) and not bool(torch.signbit(gv[gv == 0]).all())


def test_emulated_select_k_descending_rows(emulated, monkeypatch):
    """Rows that fall from start to end: every value passes the running
    threshold, so the buffer fills and is cut at every tile."""
    d = -torch.arange(6000, dtype=torch.float32).repeat(2, 1)
    for k, splits in ((7, 1), (150, 1), (150, 2)):
        _check(emulated, monkeypatch, d, k, splits=splits)


def test_emulated_select_k_refuses_what_it_cannot_take(emulated):
    """k outside 1 .. min(C, 256), splits outside 1 .. C, splits > 1
    without a workspace: refused, nothing written."""
    fn = emulation.entry(emulated, ttopk._SELECT_K)
    d = _rows(3, 2, 300, "normal")
    ws = torch.empty(2 * 300 * 257 * 8 + 8, dtype=torch.uint8)
    vals = torch.full((2, 300), -7.0)
    pos = torch.full((2, 300), -7, dtype=torch.int32)
    ptrs = [d.data_ptr(), None, vals.data_ptr(), pos.data_ptr()]
    for k, splits, w in ((0, 1, None), (257, 1, None), (301, 1, None), (10, 0, None),
                         (10, 301, ws), (10, 2, None)):
        assert fn(*ptrs, None if w is None else w.data_ptr(), 2, 300, k, splits, 1, 0,
                  None) != 0
    assert bool((vals == -7).all()) and bool((pos == -7).all())
    assert fn(*ptrs, ws.data_ptr(), 2, 300, 10, 2, 1, 0, None) == 0
    assert bool((pos.flatten()[:20] != -7).all())  # [2, 10], row-major


# each mutant's cases (R, C, k, splits, row kind): both orders, both layouts
_MUTANT_CASES = {
    "ties_reversed": [(4, 500, 10, 1, "ties"), (4, 500, 60, 2, "ties")],
    "nan_other_order": [(4, 500, 10, 2, "edge"), (4, 500, 60, 1, "edge")],
}


def test_mutants_fail_a_case(mutant, monkeypatch):
    """Each mutant differs from the plain version on each of its cases: the
    reversed ties on rows with equal values, the NaN rank on rows with
    NaN, in either order and either layout."""
    name, lib = mutant
    for R, C, k, splits, kind in _MUTANT_CASES[name]:
        d = _rows(C + k, R, C, kind)
        (gv, gp), (wv, wp), _ = _run(lib, monkeypatch, d, k, splits=splits)
        assert not (np.array_equal(gp.numpy(), wp.numpy())
                    and np.array_equal(_bits(gv), _bits(wv))), (R, C, k, splits, kind)


def test_select_k_on_cpu_runs_the_plain_version(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel launched for CPU tensors")

    monkeypatch.setattr(ttopk._SELECT_K, "launch", refuse)
    d = _rows(4, 3, 200, "edge")
    for k in (5, 40):
        gv, gp = ttopk._select_min_k(d, k)
        wv, wp = ttopk._select_min_k_plain(d, k)
        np.testing.assert_array_equal(gp.numpy(), wp.numpy())
        np.testing.assert_array_equal(_bits(gv), _bits(wv))


def test_select_k_dispatch_on_device_and_k(monkeypatch):
    """Off the CPU, `select_k` (and `_select_min_k` through it) launches the
    kernel for every k <= SELECT_K_MAX and keeps the stable sort above it;
    on the CPU it never launches. A meta tensor stands in for a CUDA one."""
    launched = []

    def launch(d, k, valid, nan_as_inf, splits=None):
        launched.append(k)
        return torch.empty((d.shape[0], k), device=d.device), None

    monkeypatch.setattr(ttopk, "_select_k_launch", launch)
    d = torch.empty((2, 400), device="meta")
    ttopk.select_k(d, ttopk.SELECT_K_MAX)
    ttopk._select_min_k(d, 20)
    ttopk.select_k(d, 40, torch.ones(400, dtype=torch.bool, device="meta"), True)
    v, p = ttopk._select_min_k(d, 300)
    assert launched == [256, 20, 40]
    assert v.shape == p.shape == (2, 300) and p.dtype == torch.int32
    x = _rows(5, 2, 400, "edge")
    gv, gp = ttopk._select_min_k(x, 300)
    wv, wp = ttopk._sort_min_k(x, 300)
    np.testing.assert_array_equal(gp.numpy(), wp.numpy())
    ttopk._select_min_k(x, 20)
    assert launched == [256, 20, 40]


def test_select_k_kernel_is_registered():
    """The kernel is built from csrc/selectk.cu at first use like the
    others, and its launches are counted under its name."""
    assert csrc.SOURCES["selectk"] == "selectk.cu"
    assert csrc.KERNELS["select_k"] is ttopk._SELECT_K
    assert ttopk._SELECT_K.library == "selectk"


def test_select_k_wrapper_refuses_shapes_it_cannot_take():
    d = _rows(6, 2, 300, "normal")
    for bad in (dict(d=d, k=257), dict(d=d[:, :20], k=21), dict(d=d.double(), k=3),
                dict(d=d[0], k=3), dict(d=d, k=3, valid=torch.ones(299, dtype=torch.bool))):
        with pytest.raises(ValueError, match="select_k"):
            ttopk._select_k_launch(bad["d"], bad["k"], bad.get("valid"), False, None)


@pytest.mark.parametrize("rows,cols,want", [
    (512, 524_288, 1),  # the oracle's chunk
    (512, 65_536, 1),  # the pivot seeding
    (512, 7_813, 1),  # the scan's first selection
    (64, 524_288, 8),
    (1, 1_000_000, 61),  # one query: 16 tiles a block
    (8192, 7_813, 1),
])
def test_select_k_splits_fill_the_card(rows, cols, want):
    assert ttopk._select_k_splits(rows, cols) == want


@pytest.mark.cuda
def test_select_k_kernel_equals_plain_on_the_card():
    """The kernel built by nvcc from csrc/selectk.cu, on the card, against
    `_select_k_plain` on the same values: values bit for bit and
    positions, both orders, both layouts, the options, one launch a call.
    The plain version runs on the host: on the card torch.sort puts a NaN
    whose sign bit is set (which `_rows` makes, as a host's arithmetic
    does) first, not last."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cases = [(R, C, k, splits, kind) for R, C, k, splits in SHAPES
             for kind in ("normal", "ties", "edge")]
    cases += [(512, 62_500, 4, None, "normal"), (512, 7_813, 12, None, "edge"),
              (64, 200_000, 100, None, "ties")]
    for R, C, k, splits, kind in cases:
        d = _rows(R * 131 + C + k, R, C, kind).to(dev)
        for valid, nan_as_inf in ((None, False), (torch.rand(C, device=dev) > 0.3, True)):
            before = ttopk._SELECT_K.launches
            gv, gp = ttopk._select_k_launch(d, k, valid, nan_as_inf, splits)
            assert ttopk._SELECT_K.launches == before + 1
            wv, wp = ttopk._select_k_plain(d.cpu(), k, None if valid is None else valid.cpu(),
                                           nan_as_inf)
            assert torch.equal(gp.cpu(), wp), (R, C, k, splits, kind)
            assert torch.equal(gv.cpu().view(torch.int32), wv.view(torch.int32)), (R, C, k)
