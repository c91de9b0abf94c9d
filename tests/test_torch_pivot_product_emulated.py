"""The `pivot_product` kernel (`csrc/pivots.cu`), compiled with g++ and run
on the CPU, against the float64 product, and the exact three-plane split
of the queries that it makes (`search.split_planes`).

The kernel multiplies f32 queries with int8 or bf16 pivot rows of the
tape on Hopper's `wgmma`: each query split into three bf16 planes (hi,
mid, lo) whose sum is the query bit for bit, each plane's products with
the same decoded rows into one f32 accumulator. Its contract is the f32
product's: every entry within the f32 dot bound 2 d 2^-24 sum |q||x| of
the float64 product. Here `tests/cuda_emulation.h` stands in for the
CUDA headers (`wgmma`, `cp.async`, the mbarriers), so the cases hold the
kernel's C++ to that bound on int8 and bf16 tapes, at widths that take
16-byte loads (128, 960, the widest one column group holds, the
text-embedding width 1,536 in two groups, 4,400 in five) and widths that
rule them out, with B not a multiple of the query tile and
B = 0, P with -1 padding, each slab width the plan picks, a NaN and an
inf query (NaN and inf where the f32 product has them), and one-hot
pivots that give back normals, values near the f32 maximum and
subnormals bit for bit, in one column group and across several. The
plan of rows that one group holds is pinned to its arithmetic, written
out here. Four mutants (the lo plane dropped; hi alone; and the two of
the tile code that `csrc/tiles.cuh` shares with K2) must each fail a case. The emulation shows what
the kernel computes, never how fast, and it cannot show a missing
barrier. One test, marked `cuda`, holds the kernel against `torch.matmul`
in f32 on the card and the seeding through it against the f32 GEMM's,
and skips elsewhere; on the card: `python -m pytest --noconftest
-o addopts="" -m cuda tests/test_torch_pivot_product_emulated.py -q`.
"""
import ctypes
import shutil
import types

import numpy as np
import pytest
import torch

import emulation
import vss_tpu_torch.index.search as tsearch
from vss_tpu_torch import csrc

# the mutants of pivots.cu: the lo plane's products dropped; the hi plane's
# alone. With them, those of the tile code it shares with K2
# (`emulation.TILE_MUTANTS`, edits of csrc/tiles.cuh).
_PLANES_LOOP = "for (int pl = 0; pl < PLANES; ++pl) {  // hi, mid, lo"
_MUTANTS = {
    "lo_dropped": [(_PLANES_LOOP, "for (int pl = 0; pl < 2; ++pl) {")],
    "hi_alone": [(_PLANES_LOOP, "for (int pl = 0; pl < 1; ++pl) {")],
}

_DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16}
_SMEM = 232448  # a block's shared memory on the H100, as the emulation reports it


def _build(tmp_path_factory, edits=(), header_edits=()):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    work = tmp_path_factory.mktemp("cuda_emulation")
    emulation.setup(work, header_edits)
    return emulation.build(work, ("pivots",), edits)["pivots"]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """libpivots built by g++ from pivots.cu."""
    return _build(tmp_path_factory)


@pytest.fixture(scope="module", params=sorted(_MUTANTS) + sorted(emulation.TILE_MUTANTS))
def mutant(request, tmp_path_factory):
    return request.param, _build(tmp_path_factory, _MUTANTS.get(request.param, ()),
                                 emulation.TILE_MUTANTS.get(request.param, ()))


def _launch(lib, q, rows, slots, dtype=None) -> torch.Tensor:
    """The emulated kernel's product over the pivots' rows [P, d]; -7
    wherever it wrote nothing. The launches it reports are one a column
    group of the plan (none without queries or pivots)."""
    fn = emulation.entry(lib, tsearch._PIVOTS)
    B, d = q.shape
    P = slots.shape[0]
    out = torch.full((B, P), -7.0)
    code = csrc.dtype_code(rows.dtype) if dtype is None else dtype
    launched = ctypes.c_int(-1)
    rc = fn(q.data_ptr(), rows.data_ptr(), slots.data_ptr(), out.data_ptr(), B, P, d, code,
            ctypes.byref(launched), None)
    if rc != 0:
        raise RuntimeError(f"emulated pivot_product refused ({rc})")
    assert lib.emu_divergence_count() == 0
    groups = -(-d // _plan(lib, d, rows.element_size())[4]) if B and P else 0
    assert launched.value == groups, (launched.value, groups)
    return out


def _world(seed, B, P, d, dtype, pad=0.1):
    """(rows [P, d], slots [P] i32, q [B, d] f32): a tape of 2P rows of int8
    values in [-127, 127] (bf16: normals x 40 rounded to bf16), P distinct
    slots with the last share `pad` of them -1 and one more inside, their
    rows as `graph_pivots` gathers them (row 0's at -1), real-valued
    queries near the rows."""
    rng = np.random.default_rng(seed)
    n = max(2 * P, 16)
    x = np.clip(np.round(rng.normal(size=(n, d)) * 50), -127, 127).astype(np.float32)
    if dtype == "bf16":
        x = rng.normal(size=(n, d)).astype(np.float32) * 40
    table = torch.from_numpy(x).to(_DTYPES[dtype])
    slots = rng.permutation(n)[:P].astype(np.int32)
    n_pad = int(P * pad)
    if n_pad:
        slots[P - n_pad:] = -1
        slots[rng.integers(0, P - n_pad)] = -1
    q = table[rng.integers(0, n, B)].float().numpy() + rng.normal(size=(B, d)) * 8
    slots = torch.from_numpy(slots)
    return (table[slots.clamp(min=0).long()].contiguous(), slots,
            torch.from_numpy(q.astype(np.float32)))


def _rows(rows, slots) -> np.ndarray:
    """The pivots' rows in float64, zeros at slot -1."""
    return np.where((slots >= 0).numpy()[:, None], rows.double().numpy(), 0.0)


def _within_bound(got, q, rows, slots) -> float:
    """The largest error against the float64 product as a share of the f32
    dot bound 2 d 2^-24 sum |q||x|; 1 or more fails."""
    x = _rows(rows, slots)
    q64 = q.double().numpy()
    want = q64 @ x.T
    bound = 2 * q.shape[1] * 2.0 ** -24 * (np.abs(q64) @ np.abs(x).T)
    err = np.abs(got.double().numpy() - want)
    assert (err <= bound).all(), float((err / np.maximum(bound, 1e-300)).max())
    return float((err / np.maximum(bound, 1e-300)).max())


# tape dtype and width: rows of whole 16-byte chunks (16-byte cp.async) at
# 128, 960, the widest one column group holds, 1,536 (two groups) and 4,400
# (five, the last one narrower), and widths that rule them out (two of them
# in two and five groups, the last one narrower)
TAPES = [("int8", 128), ("int8", 960), ("int8", 1088), ("int8", 1536), ("int8", 4400),
         ("int8", 40), ("int8", 100), ("int8", 200), ("int8", 1100), ("bf16", 128),
         ("bf16", 1024), ("bf16", 1536), ("bf16", 4100), ("bf16", 36), ("bf16", 9)]
# B, P: one query; B not a multiple of the 32-query product with P not a
# multiple of the 128-row tile; more queries than a tile of wide rows
SHAPES = [(1, 300), (33, 200), (70, 129)]


def _plan(lib, d, elem, nq=512, P=65536):
    """The kernel's plan for these sizes on the H100, of its first column
    group: (shared memory bytes, 0 if refused; slab width; stages a
    consumer; queries a tile; the group's columns)."""
    fn = lib.vss_pivot_product_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    out = [ctypes.c_int() for _ in range(4)]
    smem = fn(nq, P, d, elem, _SMEM, *(ctypes.byref(v) for v in out))
    return (smem, *(v.value for v in out))


def _one_group_plan(d, elem, nq=512):
    """The plan's arithmetic for rows that one column group holds, written
    out: (shared memory bytes, 0 if nothing fits; slab width; stages a
    consumer; queries a tile). The barriers take 1,024 bytes, then the
    ring of each consumer's stages of 128 rows, then from a 1,024-byte
    boundary the three planes of the tile's queries (atoms of 64 columns,
    128 bytes a query) and a shift a query. The first of (128 columns, 4
    stages) .. (128, 1), (64, 4) .. (64, 1) under which 32 queries fit
    wins; one slab takes at most 2 stages and as many queries as fit."""
    d16 = -(-d // 16) * 16
    qcols = -(-d16 // 64)
    per_query = 3 * qcols * 128 + 4
    nq_pad = -(-nq // 32) * 32
    for w, nsw in ((128, 4), (128, 3), (128, 2), (128, 1), (64, 4), (64, 3), (64, 2), (64, 1)):
        nslab = -(-d16 // w)
        if nslab == 1 and nsw > 2:
            continue
        q_off = -(-(1024 + 2 * nsw * 128 * min(d16, w) * elem) // 1024) * 1024
        if q_off >= _SMEM:
            continue
        fit = (_SMEM - q_off) // per_query // 32 * 32
        if fit < 32:
            continue
        nqt = min(nq_pad, fit) if nslab == 1 else 32
        return q_off + 3 * qcols * nqt * 128 + 4 * nqt, d16 if nslab == 1 else w, nsw, nqt
    return 0, 0, 0, 0


@pytest.mark.parametrize("dtype,d", TAPES)
def test_emulated_pivot_product_within_the_f32_bound(emulated, dtype, d):
    for B, P in SHAPES:
        table, slots, q = _world(B + P + d, B, P, d, dtype)
        _within_bound(_launch(emulated, q, table, slots), q, table, slots)


@pytest.mark.parametrize("dtype,d,slab", [("int8", 960, 128), ("bf16", 960, 64)])
def test_emulated_pivot_product_each_slab_width_at_the_gist_width(emulated, dtype, d, slab):
    """The gist width in the slab width the plan picks for each tape: 128
    columns for int8 rows (one stage a consumer), 64 for bf16 rows, whose
    128-column stages do not fit beside the queries."""
    assert _plan(emulated, d, 1 if dtype == "int8" else 2)[1] == slab
    table, slots, q = _world(d + slab, 40, 260, d, dtype)
    _within_bound(_launch(emulated, q, table, slots), q, table, slots)


def test_emulated_pivot_product_nan_and_inf_queries(emulated):
    """A NaN value makes its query's every product NaN; an inf value makes
    +-inf, or NaN against a 0 or against the other infinity: where the
    f32 product has them. The other queries stay within the bound."""
    table, slots, q = _world(3, 6, 300, 48, "int8")
    q[1, 3] = float("nan")
    q[2, 5] = float("inf")
    q[3, 7] = -float("inf")
    q[3, 9] = float("inf")
    got = _launch(emulated, q, table, slots).numpy()
    with np.errstate(invalid="ignore"):
        want = q.double().numpy() @ _rows(table, slots).T
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fine = [0, 4, 5]
    _within_bound(torch.from_numpy(got[fine]), q[fine], table, slots)


def _one_hot(d, P):
    """P pivots of one-hot int8 rows (slot k's row: 1 at column k): a
    permutation of d slots, then -1; and their slots."""
    eye = torch.zeros((d + 3, d), dtype=torch.int8)
    eye[torch.arange(d), torch.arange(d)] = 1
    rng = np.random.default_rng(d)
    slots = torch.from_numpy(
        np.concatenate([rng.permutation(d), np.full(P - d, -1)]).astype(np.int32))
    return eye[slots.clamp(min=0).long()].contiguous(), slots


def _special_rows(rng, B, d) -> torch.Tensor:
    """B rows each of normals, normals near the f32 maximum, subnormals of
    either sign, and normals with zeros of either sign."""
    normal = rng.normal(size=(B, d)).astype(np.float32)
    sub = (rng.integers(1, 2 ** 23, (B, d)).astype(np.uint32)
           | (rng.integers(0, 2, (B, d)).astype(np.uint32) << 31)).view(np.float32)
    zeros = normal.copy()
    zeros[:, ::3] = 0.0
    zeros[:, 1::3] = -0.0
    return torch.from_numpy(np.concatenate([normal, normal * np.float32(3e37), sub, zeros]))


@pytest.mark.parametrize("d", [200, 960, 1536, 4400])
def test_emulated_one_hot_pivots_give_back_the_queries(emulated, d):
    """Against one-hot rows each product is one query value, which the
    three planes hold whole: bit for bit for normals, values near the f32
    maximum and subnormals (s lifts them, 2^-s puts them back); a zero
    gives a zero. Past one column group (1,536: two; 4,400: five) the
    value comes from its group, each group with its own s, and the other
    groups add zeros."""
    eye, slots = _one_hot(d, d + 56)
    q = _special_rows(np.random.default_rng(d), 2, d).contiguous()
    got = _launch(emulated, q, eye, slots)
    want = torch.where((slots >= 0)[None, :], q[:, slots.clamp(min=0).long()], 0.0)
    nz = want != 0
    np.testing.assert_array_equal(got[nz].view(torch.int32).numpy(),
                                  want[nz].view(torch.int32).numpy())
    assert bool((got[~nz] == 0).all())


def test_emulated_pivot_product_past_the_split(emulated):
    """A row of 1 and 2^-140 lies past what the split holds: each 2^-140 is
    lost, the product off by at most the bits below 2^-133 of its values
    times |x|, and within the f32 bound wherever a 1 takes part."""
    eye, slots = _one_hot(64, 100)
    q = torch.ones((1, 64))
    q[0, 1::2] = 2.0 ** -140
    got = _launch(emulated, q, eye, slots).double().numpy()
    x = _rows(eye, slots)
    err = np.abs(got - q.double().numpy() @ x.T)
    assert (err <= 2.0 ** -133 * np.abs(x).sum(1)[None, :]).all()
    ones = (slots.numpy() >= 0) & (slots.numpy() % 2 == 0)
    assert (got[0, ones] == 1.0).all()


def test_emulated_pivot_product_empty_batch_and_no_pivots(emulated):
    table, slots, q = _world(4, 3, 64, 32, "int8")
    assert _launch(emulated, q[:0], table, slots).shape == (0, 64)
    out = _launch(emulated, q, table, slots[:0])
    assert out.shape == (3, 0)


def test_emulated_pivot_product_refuses_what_it_cannot_take(emulated):
    """An f32 tape (dtype 0): refused."""
    table, slots, q = _world(5, 2, 64, 960, "bf16")
    with pytest.raises(RuntimeError, match="refused"):
        _launch(emulated, q, table, slots, dtype=0)


def test_pivot_product_takes_the_widths_the_plan_fits(emulated):
    """`pivot_product_takes` (the routing's test) accepts every int8 and
    bf16 tape and no f32 one, and the kernel's plan takes every width, at
    one query and at 512, in the fewest column groups that fit: one group
    of the whole row up to 1,088 int8 / 1,024 bf16 values; past it groups
    of whole 64-column atoms, none wider than that, where one group fewer
    would have to be wider. The plan at the gist width (slabs of 128, one
    stage a consumer, 32 queries, 218,240 bytes, one group) and at sift's
    (one slab, 192 queries), and at the text-embedding width 1,536 (two
    groups of 768 columns: int8 in slabs of 128 with two stages a
    consumer, bf16 with one)."""
    assert [tsearch.pivot_product_takes(t) for t in (torch.int8, torch.bfloat16, torch.float32)] \
        == [True, True, False]
    for elem, widest in ((1, 1088), (2, 1024)):
        for d in list(range(1, 4609, 5)) + [1024, 1025, 1088, 1089, 1536, 3072, 4096, 4097, 4352,
                                            4353, 8192, 12288]:
            for nq in (1, 512):
                smem, _, _, _, group = _plan(emulated, d, elem, nq=nq)
                assert smem > 0, (elem, d, nq)
                if d <= widest:
                    assert group == d, (elem, d, nq)
                    continue
                groups, d16 = -(-d // group), -(-d // 16) * 16
                assert group <= widest and group % 64 == 0, (elem, d, nq)
                assert -(-(-(-d16 // (groups - 1))) // 64) * 64 > widest, (elem, d, nq)
    assert _plan(emulated, 960, 1) == (218240, 128, 1, 32, 960)
    smem, slab, nsw, nqt, group = _plan(emulated, 128, 1)
    assert smem > 0 and (slab, nsw, nqt, group) == (128, 2, 192, 128)
    assert _plan(emulated, 1536, 1) == (214144, 128, 2, 32, 768)
    assert _plan(emulated, 1536, 2)[1:] == (128, 1, 32, 768)
    assert _plan(emulated, 4352, 1)[4] == 1088 and _plan(emulated, 4096, 2)[4] == 1024


@pytest.mark.parametrize("dtype,elem,widest", [("int8", 1, 1088), ("bf16", 2, 1024)])
def test_the_plan_of_rows_one_group_holds_is_its_arithmetic(emulated, dtype, elem, widest):
    """Up to the widest row one column group holds, the plan is one group
    of the whole row, and its slab, stages, queries a tile and shared
    memory are those of the plan's arithmetic (`_one_group_plan`) at every
    width, at one query and at 512: the column groups change nothing
    there. Past it there is more than one group."""
    for d in range(1, widest + 1):
        for nq in (1, 512):
            assert _plan(emulated, d, elem, nq=nq) == (*_one_group_plan(d, elem, nq), d), (d, nq)
    assert _plan(emulated, widest + 1, elem)[4] < widest + 1


# each mutant's cases (seed, B, P, d, dtype); the tile code's with more
# than 8 queries, so that a product's queries span several atoms, in one
# slab and in three
_TILE_CASES = [(7, 40, 200, 16, "int8"), (7, 40, 200, 272, "bf16")]
_MUTANT_CASES = {"lo_dropped": [(7, 8, 200, 16, "int8")], "hi_alone": [(7, 8, 200, 16, "int8")],
                 "descriptor_stride": _TILE_CASES, "subsegment_rows": _TILE_CASES}


def test_mutants_fail_a_case(mutant):
    """Each mutant leaves the f32 bound on real-valued queries in each of
    its cases (at d = 16 the bound is 2^-19 of sum |q||x|, and lo's part
    is about 2^-17)."""
    name, lib = mutant
    for seed, B, P, d, dtype in _MUTANT_CASES[name]:
        table, slots, q = _world(seed, B, P, d, dtype)
        with pytest.raises(AssertionError):
            _within_bound(_launch(lib, q, table, slots), q, table, slots)


# ---- the split and the plain version, on the CPU


def _bits(v: torch.Tensor) -> np.ndarray:
    return v.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("kind", ["normal", "huge", "subnormal", "zeros", "tiny"])
def test_split_planes_reproduce_the_queries_bit_for_bit(kind):
    """hi + mid + lo, summed in f32 in that order, times 2^-s, is the query
    bit for bit (-0 too), each plane a bf16 value: normals, values near
    the f32 maximum, subnormals of either sign, rows with zeros of either
    sign, and values down to 2^-103 beside values near 1."""
    rng = np.random.default_rng(len(kind))
    rows = _special_rows(rng, 3, 97)
    q = {"normal": rows[:3], "huge": rows[3:6], "subnormal": rows[6:9], "zeros": rows[9:12]}.get(
        kind)
    if kind == "tiny":
        q = rows[:3].clone()
        q[:, ::2] = torch.from_numpy(np.ldexp(1.0 + rng.random((3, 49)), -103).astype(np.float32))
    hi, mid, lo, s = tsearch.split_planes(q)
    for plane in (hi, mid, lo):
        assert not (_bits(plane) & 0xFFFF).any()
    back = ((hi + mid) + lo) * torch.exp2(-s.float())[:, None]
    np.testing.assert_array_equal(_bits(back), _bits(q))
    assert bool(((s >= 0) & (s <= 23)).all())
    if kind == "subnormal":
        assert bool((s > 0).all())
    if kind in ("normal", "huge"):
        assert bool((s == 0).all())


def test_split_planes_keep_inf_and_nan_whole():
    q = torch.ones((2, 8))
    q[0, 1] = float("inf")
    q[1, 2] = float("nan")
    q[1, 3] = 1e-40
    hi, mid, lo, s = tsearch.split_planes(q)
    assert s.tolist() == [0, 0]
    assert torch.isposinf(hi[0, 1]) and torch.isnan(hi[1, 2])
    assert float(mid[0, 1]) == float(lo[0, 1]) == float(mid[1, 2]) == 0.0


def test_plain_pivot_product_within_the_bound_and_the_cpu_route():
    """The plain version (`_pivot_product_plain`) holds the same bound, and
    the wrapper takes it for CPU tensors."""
    for dtype, d in (("int8", 960), ("bf16", 36), ("int8", 1536)):
        table, slots, q = _world(8, 5, 300, d, dtype)
        plain = tsearch._pivot_product_plain(q, table, slots)
        _within_bound(plain, q, table, slots)
        assert torch.equal(tsearch.pivot_product(q, table, slots), plain)


def test_pivot_product_wrapper_refuses_what_it_cannot_take():
    table, slots, q = _world(9, 2, 64, 16, "int8")
    for bad in (dict(rows=table.float()), dict(q=q.double()), dict(q=q[:, :8]),
                dict(rows=table[:5]), dict(rows=table[:, :0], q=q[:, :0]),
                dict(pivot_slots=slots[None])):
        kw = dict(dict(q=q, rows=table, pivot_slots=slots), **bad)
        with pytest.raises(ValueError, match="pivot_product"):
            tsearch.pivot_product(**kw)


def test_pivot_product_kernel_is_registered():
    assert csrc.SOURCES["pivots"] == "pivots.cu"
    assert csrc.KERNELS["pivot_product"] is tsearch._PIVOTS
    assert tsearch._PIVOTS.library == "pivots"


@pytest.mark.cuda
def test_pivot_product_kernel_on_the_card():
    """On the card: the kernel against the float64 product within the f32
    dot bound, and against `torch.matmul` in f32 (the route it replaced)
    within the same bound; the seeding through it (`scored_pivot_seeds`)
    against the f32 GEMM's: seeds equal wherever the GEMM route's k-th and
    (k+1)-th nearest pivots lie farther apart than the two products'
    error, each seed's distance K1's bit for bit; one launch of each
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vss_tpu_torch.index.graph import HNSWConfig
    from vss_tpu_torch.ops.distance import Metric, _epilogue
    from vss_tpu_torch.ops.gather import gather_distances

    dev = torch.device("cuda")
    for dtype, d in TAPES:
        for B, P in SHAPES + [(512, 4096)]:
            table, slots, q = (t.to(dev) for t in _world(B + P + d, B, P, d, dtype))
            got = tsearch.pivot_product(q, table, slots)
            x = _rows(table.cpu(), slots.cpu())
            _within_bound(got.cpu(), q.cpu(), table.cpu(), slots.cpu())
            lib = (q @ torch.from_numpy(x).to(dev).float().T).double().cpu().numpy()
            bound = 2 * d * 2.0 ** -24 * (np.abs(q.double().cpu().numpy()) @ np.abs(x).T)
            assert (np.abs(got.double().cpu().numpy() - lib) <= bound).all(), (dtype, d, B)
    rows, slots, q = (t.to(dev) for t in _world(1, 512, 8192, 960, "int8"))
    # a tape whose rows at the slots are the pivots' rows
    table = torch.zeros((int(slots.max()) + 1, 960), dtype=torch.int8, device=dev)
    table[slots[slots >= 0].long()] = rows[slots >= 0]
    cfg = HNSWConfig(dims=960, metric="l2sq", storage_dtype="int8")
    graph = types.SimpleNamespace(vectors=table)
    pv = table[slots.clamp(min=0).long()]
    pvf = pv.float()
    qn, pn = (q * q).sum(-1), (pvf * pvf).sum(-1)
    before = (tsearch._PIVOTS.launches, tsearch._SEEDS.launches)
    seeds, seed_d = tsearch.scored_pivot_seeds(graph, cfg, q, slots, pv, 4, qn, pn)
    assert (tsearch._PIVOTS.launches, tsearch._SEEDS.launches) == (before[0] + 1, before[1] + 1)
    dots = q @ pvf.T
    want, _ = tsearch._pivot_seeds_launch(dots, qn, pn, slots, table, q, "l2sq", 4)
    k1 = gather_distances(table, seeds, q, "l2sq", qn)
    assert torch.equal(seed_d.view(torch.int32), k1.view(torch.int32))
    differ = (seeds != want).any(1).nonzero()[:, 0]
    if differ.numel():
        dq = torch.where((slots >= 0)[None, :], _epilogue(
            dots[differ], qn[differ, None], pn[None, :], Metric.L2SQ), float("inf"))
        near = torch.topk(dq, 5, largest=False).values.double()
        x = torch.from_numpy(_rows(pv.cpu(), slots.cpu())).to(dev)
        err = 2 * 2 * 2 * 960 * 2.0 ** -24 * (q[differ].double().abs() @ x.abs().T).amax(1)
        assert bool(((near[:, 1:] - near[:, :-1]).amin(1) <= 2 * err).all())
