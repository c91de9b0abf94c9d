"""The CUDA source of the `pivot_seeds` kernel (`csrc/seeds.cu`), compiled
with g++ and run on the CPU, against the route it replaces: `pivot_seeds`
(the metric epilogue and the padding mask in PyTorch, then the emulated
`select_k` kernel, then the slot map) and the emulated K1
(`gather_distances`' kernel, `csrc/gather.cu`) over its seeds.

There is no nvcc and no card where these tests run, so the kernel itself
is held against that route only on the card (`chip_smoke.py`,
`check_pivot_seeds`). What runs here is its C++: `tests/cuda_emulation.h`
stands in for the CUDA headers and runs a block's threads as cooperative
fibers that switch at every barrier and warp exchange; `tests/emulation.py`
turns the `<<<...>>>` launch into a call and the dynamic shared memory
into a pointer, and changes nothing else.

The contract is exact: seeds equal and their distances bit for bit, both
computed from the same product `q @ pivots^T`. Every metric on int8, bf16
and f32 tapes, at widths that take 16-byte loads and widths that rule
them out; n_seeds 1, 4, 32 and 33 (both of select_k's orders); P = 1, 7
and 4,096 with -1 padding; rows in one block and rows split over
several; ties between duplicate pivot rows; a NaN query, zero vectors
under cosine, every slot -1, P below n_seeds, B = 0 and the 960-d cosine
width. Two mutants (ties to the higher position; the l2sq epilogue summed
as qn + (pn - 2 dot)) must each fail a case. The emulation shows what the
kernel computes, never how fast, and it cannot show a missing barrier.
One test, marked `cuda`, holds the kernel itself against the route where
a CUDA device is present and skips elsewhere; on the card (no JAX there,
so without this directory's conftest): `python -m pytest --noconftest
-o addopts="" -m cuda tests/test_torch_seeds_emulated.py -q`.
"""
import shutil
import types

import numpy as np
import pytest
import torch

import emulation
import vss_tpu_torch.index.search as tsearch
import vss_tpu_torch.ops.topk as ttopk
from vss_tpu_torch import csrc
from vss_tpu_torch.index.graph import HNSWConfig
from vss_tpu_torch.ops import gather as tgather
from vss_tpu_torch.ops.distance import METRIC_IDS, Metric

# the two mutants, each (edits of seeds.cu, edits of the shared headers):
# positions stored reversed in the composite (ties to the higher position,
# positions still decoded right); the l2sq epilogue summed in another order
_MUTANTS = {
    "ties_to_higher": ([
        ("static_cast<unsigned>(p);", "static_cast<unsigned>(0x7fffffff - p);"),
        ("const int p = static_cast<int>(c & 0xffffffffull);",
         "const int p = 0x7fffffff - static_cast<int>(c & 0xffffffffull);"),
    ], []),
    "l2sq_other_order": ([], [
        ("float v = __fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.0f, dot));",
         "float v = __fadd_rn(qn, __fsub_rn(xn, __fmul_rn(2.0f, dot)));"),
    ]),
}

_DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}


def _build(tmp_path_factory, libraries, edits=(), header_edits=()):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    work = tmp_path_factory.mktemp("cuda_emulation")
    emulation.setup(work, header_edits)
    return emulation.build(work, libraries, edits)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """libseeds, libselectk and libgather built by g++ from the sources."""
    return _build(tmp_path_factory, ("seeds", "selectk", "gather"))


@pytest.fixture(scope="module", params=sorted(_MUTANTS))
def mutant(request, tmp_path_factory):
    edits, header_edits = _MUTANTS[request.param]
    return request.param, _build(tmp_path_factory, ("seeds",), edits, header_edits)["seeds"]


def _route_launches(monkeypatch, kernel, lib) -> list:
    """Route `kernel`'s launches to its entry point in the emulated `lib`;
    returns the list each launch's arguments are appended to."""
    fn = emulation.entry(lib, kernel)
    launched = []

    def launch(operands, *args):
        rc = fn(*args, None)
        if rc != 0:
            raise RuntimeError(f"{kernel.name}: emulated launch refused ({rc})")
        launched.append(args)

    monkeypatch.setattr(kernel, "launch", launch)
    return launched


def _k1(lib, table, ids, q, qn, metric) -> torch.Tensor:
    """The emulated K1 over ids [B, C]: what `gather_distances` launches."""
    fn = emulation.entry(lib, tgather._K1)
    ids = ids.to(torch.int32).contiguous()
    out = torch.empty(ids.shape, dtype=torch.float32)
    B, C = ids.shape
    if B and C:
        assert fn(ids.data_ptr(), q.data_ptr(), qn.data_ptr(), table.data_ptr(),
                  out.data_ptr(), B, C, table.shape[1], csrc.dtype_code(table.dtype),
                  METRIC_IDS[Metric.parse(metric)], None) == 0
    return out


def _world(seed, B, P, d, dtype, n=None, kind="normal", pad=0.25):
    """(table [n, d], slots [P] i32, pivots [P, d] f32, q [B, d] f32): a
    tape of real values (int8: integers), P pivot slots of distinct rows
    with a share `pad` of them -1 (the tail, as a sample pads, and two
    inside), queries near the rows. kind "ties": small integers, each row
    repeated three times in the tape, so that pivots tie."""
    rng = np.random.default_rng(seed)
    n = n or max(2 * P, 16)
    if kind == "ties":
        x = np.repeat(rng.integers(-3, 4, (n // 3 + 1, d)), 3, 0)[:n].astype(np.float32)
        qv = rng.integers(-3, 4, (B, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        if dtype == "int8":
            x = np.round(x * 20)
        qv = (x[rng.integers(0, n, B)] + rng.normal(size=(B, d))).astype(np.float32)
    table = torch.from_numpy(x).to(_DTYPES[dtype])
    slots = rng.permutation(n)[:P].astype(np.int32)
    n_pad = int(P * pad)
    if n_pad:
        slots[P - n_pad:] = -1
        slots[rng.choice(P - n_pad, min(2, P - n_pad), replace=False)] = -1
    slots = torch.from_numpy(slots)
    pivots = table[slots.clamp(min=0).long()].float()
    return table, slots, pivots, torch.from_numpy(qv)


def _run(libs, monkeypatch, table, slots, pivots, q, metric, n_seeds, splits=None):
    """(the emulated kernel's (seeds, seed_d), the route's, launches)."""
    _route_launches(monkeypatch, ttopk._SELECT_K, libs["selectk"])
    # the route's selection: the select_k kernel, whatever the device
    monkeypatch.setattr(ttopk, "select_k",
                        lambda d, k, valid=None, nan_as_inf=False: ttopk._select_k_launch(
                            d, k, valid, nan_as_inf))
    launched = _route_launches(monkeypatch, tsearch._SEEDS, libs["seeds"])
    cfg = HNSWConfig(dims=table.shape[1], metric=metric)
    graph = types.SimpleNamespace(vectors=table)
    qn = (q * q).sum(-1)
    pn = (pivots * pivots).sum(-1)
    dots = q @ pivots.T
    k = min(n_seeds, slots.shape[0])
    got = tsearch._pivot_seeds_launch(dots, qn, pn, slots, table, q, metric, k, splits)
    seeds, _ = tsearch.pivot_seeds(graph, cfg, q, slots, pivots, n_seeds, qn)
    want = (seeds, _k1(libs["gather"], table, seeds, q, qn, metric))
    for lib in libs.values():
        assert lib.emu_divergence_count() == 0
    return got, want, len(launched)


def _bits(v: torch.Tensor) -> np.ndarray:
    return v.contiguous().view(torch.int32).numpy()


def _check(libs, monkeypatch, table, slots, pivots, q, metric, n_seeds, splits=None):
    (gs, gd), (ws, wd), launches = _run(libs, monkeypatch, table, slots, pivots, q, metric,
                                        n_seeds, splits)
    B, k = q.shape[0], min(n_seeds, slots.shape[0])
    assert launches == int(B > 0 and k > 0)
    assert gs.dtype == torch.int32 and gd.dtype == torch.float32
    assert gs.shape == gd.shape == ws.shape == (B, k)
    np.testing.assert_array_equal(gs.numpy(), ws.numpy())
    np.testing.assert_array_equal(_bits(gd), _bits(wd))
    return gs, gd


# P, n_seeds, B, splits (None: the wrapper's choice)
SHAPES = [
    (4096, 4, 3, None),  # the serving k, one block a row
    (4096, 4, 1, 3),  # one query, its row split over three blocks
    (4096, 1, 3, None),  # the sharded insert's single seed
    (4096, 32, 2, 2),  # the widest k of _iter_min_k's order
    (4096, 33, 2, None),  # the stable sort's order
    (7, 4, 3, None),  # P not a multiple of 4: narrow loads
    (7, 33, 2, 2),  # P below n_seeds
    (1, 4, 2, None),  # one pivot
]

# tape dtype and width: 16-byte loads of its rows (32 int8, 24 bf16, 12
# f32) and widths that rule them out
TAPES = [("int8", 32), ("int8", 20), ("bf16", 24), ("bf16", 9), ("f32", 12), ("f32", 7)]


@pytest.mark.parametrize("dtype,d", TAPES)
@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_emulated_pivot_seeds_equal_the_route(emulated, monkeypatch, metric, dtype, d):
    for P, n_seeds, B, splits in SHAPES:
        world = _world(P * 7 + n_seeds + B + d, B, P, d, dtype)
        _check(emulated, monkeypatch, *world, metric, n_seeds, splits)


@pytest.mark.parametrize("n_seeds,splits", [(4, 1), (4, 3), (32, 2), (33, 1), (33, 3)])
def test_emulated_pivot_seeds_ties(emulated, monkeypatch, n_seeds, splits):
    """Pivots whose rows repeat (each three times), integer values: equal
    distances everywhere, broken to the lower pivot position."""
    table, slots, pivots, q = _world(n_seeds + splits, 3, 600, 16, "f32", kind="ties", pad=0)
    for metric in ("l2sq", "cosine", "ip"):
        _check(emulated, monkeypatch, table, slots, pivots, q, metric, n_seeds, splits)


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_emulated_pivot_seeds_nan_and_zero_queries(emulated, monkeypatch, metric):
    """A NaN query (l2sq and ip: every value NaN, every seed -1 at +inf;
    cosine: every value 1), a zero query and zero pivot rows (cosine's
    guards), and NaN among the values of a row (an f32 tape's NaN row)."""
    table, slots, pivots, q = _world(5, 4, 300, 12, "f32")
    q[1, 3] = float("nan")
    q[2] = 0.0
    table[slots[:5].clamp(min=0).long()] = 0.0
    table[int(slots[7]), 2] = float("nan")
    pivots = table[slots.clamp(min=0).long()].float()
    for n_seeds, splits in ((4, 1), (4, 2), (33, 1), (33, 2)):
        gs, gd = _check(emulated, monkeypatch, table, slots, pivots, q, metric, n_seeds, splits)
        if metric != "cosine":
            assert bool((gs[1] == -1).all()) and bool(torch.isinf(gd[1]).all())


def test_emulated_pivot_seeds_every_slot_padding(emulated, monkeypatch):
    table, slots, pivots, q = _world(6, 3, 64, 16, "int8")
    slots = torch.full_like(slots, -1)
    for metric in ("l2sq", "cosine"):
        for n_seeds, splits in ((4, 1), (40, 2)):
            gs, gd = _check(emulated, monkeypatch, table, slots, pivots, q, metric, n_seeds,
                            splits)
            assert bool((gs == -1).all()) and bool(torch.isinf(gd).all())


def test_emulated_pivot_seeds_empty_batch_and_k_zero(emulated, monkeypatch):
    table, slots, pivots, q = _world(7, 3, 64, 16, "int8")
    _check(emulated, monkeypatch, table, slots, pivots, q[:0], "l2sq", 4)
    (gs, gd), _, launches = _run(emulated, monkeypatch, table, slots[:0], pivots[:0], q,
                                 "l2sq", 4)
    assert launches == 0 and gs.shape == gd.shape == (3, 0)


def test_emulated_pivot_seeds_gist_width(emulated, monkeypatch):
    """The gist arm's width: 960-d int8 rows under cosine (60 16-byte
    chunks a row, a full warp a row), and the same rows as f32."""
    world = _world(8, 2, 300, 960, "int8", n=400)
    for n_seeds, splits in ((4, 1), (4, 2)):
        _check(emulated, monkeypatch, *world, "cosine", n_seeds, splits)
    table, slots, pivots, q = world
    _check(emulated, monkeypatch, table.float(), slots, pivots, q, "l2sq", 4)


def test_emulated_pivot_seeds_refuse_what_they_cannot_take(emulated):
    """k outside 1 .. min(P, 256), splits outside 1 .. P, splits > 1 without
    a workspace, an unknown dtype or metric: refused, nothing written."""
    fn = emulation.entry(emulated["seeds"], tsearch._SEEDS)
    table, slots, pivots, q = _world(9, 2, 300, 16, "f32")
    dots, qn, pn = q @ pivots.T, (q * q).sum(-1), (pivots * pivots).sum(-1)
    seeds = torch.full((2, 300), -7, dtype=torch.int32)
    seed_d = torch.full((2, 300), -7.0)
    ws = torch.empty(2 * 300 * 257 * 8 + 8, dtype=torch.uint8)
    ptrs = [t.data_ptr() for t in (dots, qn, pn, slots, table, q, seeds, seed_d)]
    for k, splits, w, dtype, metric in ((0, 1, None, 0, 0), (257, 1, None, 0, 0),
                                        (301, 1, None, 0, 0), (4, 0, None, 0, 0),
                                        (4, 301, ws, 0, 0), (4, 2, None, 0, 0),
                                        (4, 1, None, 3, 0), (4, 1, None, 0, 3)):
        assert fn(*ptrs, None if w is None else w.data_ptr(), 2, 300, 16, dtype, metric, k,
                  splits, None) != 0
    assert bool((seeds == -7).all()) and bool((seed_d == -7).all())
    assert fn(*ptrs, ws.data_ptr(), 2, 300, 16, 0, 0, 4, 2, None) == 0
    assert bool((seeds.flatten()[:8] != -7).all())  # [2, 4], row-major


# each mutant's cases (P, n_seeds, B, splits, world kind, metric)
_MUTANT_CASES = {
    "ties_to_higher": [(600, 4, 3, 1, "ties", "l2sq"), (600, 33, 3, 2, "ties", "ip")],
    "l2sq_other_order": [(4096, 4, 3, 1, "normal", "l2sq"), (4096, 4, 1, 3, "normal", "l2sq")],
}


def test_mutants_fail_a_case(mutant, emulated, monkeypatch):
    """Each mutant differs from the route on each of its cases: the ties
    on pivots whose rows repeat, the l2sq order on real-valued rows."""
    name, lib = mutant
    libs = dict(emulated, seeds=lib)
    for P, n_seeds, B, splits, kind, metric in _MUTANT_CASES[name]:
        world = _world(P + n_seeds, B, P, 16, "f32", kind=kind, pad=0 if kind == "ties" else 0.25)
        (gs, gd), (ws, wd), _ = _run(libs, monkeypatch, *world, metric, n_seeds, splits)
        assert not (np.array_equal(gs.numpy(), ws.numpy())
                    and np.array_equal(_bits(gd), _bits(wd))), (name, P, n_seeds, splits)


def test_pivot_seeds_kernel_is_registered():
    """The kernel is built from csrc/seeds.cu at first use like the others,
    and its launches are counted under its name."""
    assert csrc.SOURCES["seeds"] == "seeds.cu"
    assert csrc.KERNELS["pivot_seeds"] is tsearch._SEEDS
    assert tsearch._SEEDS.library == "seeds"


def test_pivot_seeds_wrapper_refuses_shapes_it_cannot_take():
    table, slots, pivots, q = _world(10, 2, 64, 16, "f32")
    dots, qn, pn = q @ pivots.T, (q * q).sum(-1), (pivots * pivots).sum(-1)
    good = dict(dots=dots, qn=qn, pn=pn, pivot_slots=slots, table=table, q=q, metric="l2sq", k=4)
    for bad in (dict(k=257), dict(k=65), dict(dots=dots.double()), dict(q=q[:, :8]),
                dict(qn=qn[:1]), dict(pn=pn[:5]), dict(pivot_slots=slots[:5])):
        with pytest.raises(ValueError, match="pivot_seeds"):
            tsearch._pivot_seeds_launch(**dict(good, **bad))


@pytest.mark.cuda
def test_pivot_seeds_kernel_equals_the_route_on_the_card():
    """The kernel built by nvcc from csrc/seeds.cu, on the card, against the
    route it replaces there (`pivot_seeds`, whose selection is the select_k
    kernel, then K1): seeds equal and distances bit for bit, one launch a
    call, both layouts, every metric and tape dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for dtype, d in TAPES + [("int8", 128)]:
        for metric in ("l2sq", "cosine", "ip"):
            for P, n_seeds, B, splits in SHAPES + [(65_536, 4, 64, None), (65_536, 4, 1, None)]:
                table, slots, pivots, q = (t.to(dev) for t in _world(
                    P + n_seeds + B + d, B, P, d, dtype))
                cfg = HNSWConfig(dims=d, metric=metric)
                graph = types.SimpleNamespace(vectors=table)
                qn = (q * q).sum(-1)
                k = min(n_seeds, P)
                before = tsearch._SEEDS.launches
                gs, gd = tsearch._pivot_seeds_launch(q @ pivots.T, qn, (pivots * pivots).sum(-1),
                                                     slots, table, q, metric, k, splits)
                assert tsearch._SEEDS.launches == before + 1
                ws, _ = tsearch.pivot_seeds(graph, cfg, q, slots, pivots, n_seeds, qn)
                wd = tgather.gather_distances(table, ws, q, metric, qn)
                assert torch.equal(gs, ws), (dtype, d, metric, P, n_seeds, B)
                assert torch.equal(gd.view(torch.int32), wd.view(torch.int32)), (dtype, metric)
