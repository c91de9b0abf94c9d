"""The CUDA sources of the gather kernels and of `beam_search`, compiled
with g++ and run on the CPU, against their plain versions: `beam_search`
in both of its layouts (pools in shared memory, and pools in a workspace
in device memory for ef past a block's shared memory), and with more
neighbour slots a step than a block has threads.

There is no nvcc and no card where these tests run, so the kernels
themselves are held against their plain versions only on the card
(`chip_smoke.py`). What can run here is their C++: `tests/cuda_emulation.h`
stands in for the CUDA headers and runs a block's threads as cooperative
fibers that switch at every barrier and warp exchange. The sources are
taken as they are, apart from the textual changes that
`tests/emulation.py` makes: the `<<<...>>>` launches become calls and the
dynamic shared-memory declarations become pointers.

The emulation shows what a kernel computes (index arithmetic, the merge
network, tie and NaN rules, the shared-memory layout), never how fast, and
it cannot show a missing barrier. Inputs are integer-valued, so every f32
sum is exact in any order and the kernel must equal the plain loop exactly,
as it must on the card against the loop through K1 and K5.
"""
import shutil

import numpy as np
import pytest
import torch

import emulation
import vss_tpu_torch.index.search as tsearch
from vss_tpu_torch import HNSWConfig, HNSWIndex, csrc
from vss_tpu_torch.ops import gather as tgather


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """libgather and libbeam built by g++ from the .cu sources."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    work = tmp_path_factory.mktemp("cuda_emulation")
    emulation.setup(work)
    return emulation.build(work, ("gather", "beam"))


@pytest.fixture(scope="module")
def world():
    """A small index over integer-valued vectors and its beam inputs."""
    rng = np.random.default_rng(3)
    n, d = 900, 24
    vecs = rng.integers(-6, 7, (n, d)).astype(np.float32)
    idx = HNSWIndex.build(vecs, HNSWConfig(dims=d, m=6), method="native", device="cpu")
    g = idx.graph
    q = torch.from_numpy(rng.integers(-6, 7, (6, d)).astype(np.float32))
    q[4, 2] = float("nan")
    allow = g.valid & torch.from_numpy(rng.random(g.capacity) > 0.2)
    seeds0 = torch.from_numpy(rng.integers(0, n, (6, 3)).astype(np.int32))
    seeds0[1] = -1
    seeds0[2, 1:] = -1
    upper = torch.nonzero(g.levels >= 1)[:, 0].to(torch.int32)
    seeds1 = upper[torch.from_numpy(rng.integers(0, upper.numel(), 6))]
    return idx, q, allow, seeds0, seeds1


def _tape(g, storage):
    if storage == "f32":
        return g.vectors
    return g.vectors.to({"int8": torch.int8, "bf16": torch.bfloat16}[storage])


CASES = [
    # storage, metric, dual, hist, E, level, ef
    ("f32", "l2sq", False, True, 1, 0, 16),
    ("f32", "l2sq", True, True, 1, 0, 16),
    ("f32", "l2sq", True, False, 2, 0, 24),
    ("f32", "l2sq", False, True, 4, 0, 40),
    ("f32", "l2sq", True, True, 4, 1, 8),
    ("f32", "l2sq", False, False, 1, 1, 16),
    ("int8", "l2sq", True, True, 2, 0, 16),
    ("int8", "ip", False, True, 1, 0, 64),
    ("bf16", "l2sq", True, True, 1, 0, 100),
    ("bf16", "ip", True, False, 4, 1, 16),
]

# Rows of 512 bytes or more, which the kernel scores by the staged route
# (bulk copies, `score_row_wide`), at the graph cells' widths and fan-out (m=16,
# m0=32): (rows of the graph, d) + a case of CASES. The serving shapes
# (single pool, history, E=1: 32 slots), both pools, E=4 (128 slots at
# level 0), the f32 and bf16 tapes, a graph of 40 rows under a pool of 48,
# whose iterations find most ids already seen, and pools of 1,000 that
# leave shared memory for a few rows a phase, so that a step's live rows
# land in several phases.
WIDE_CASES = [
    (600, 960, "int8", "l2sq", False, True, 1, 0, 64),
    (600, 1536, "int8", "cosine", False, True, 1, 0, 64),
    (600, 1536, "int8", "l2sq", True, True, 1, 0, 32),
    (600, 960, "int8", "cosine", True, True, 1, 0, 24),
    (600, 960, "bf16", "l2sq", True, True, 1, 0, 32),
    (600, 960, "f32", "ip", False, True, 2, 0, 16),
    (600, 960, "int8", "l2sq", False, False, 4, 0, 40),
    (600, 1536, "int8", "l2sq", True, True, 4, 1, 16),
    (40, 960, "int8", "l2sq", True, True, 1, 0, 48),
    (200, 1536, "int8", "l2sq", True, True, 1, 0, 1000),
]


@pytest.fixture(scope="module")
def wide_world():
    """Small integer-valued indexes at m=16, built on first use, by (rows,
    d): a world as `world` gives, four queries."""
    built = {}

    def get(n, d):
        if (n, d) not in built:
            rng = np.random.default_rng(d + n)
            vecs = rng.integers(-6, 7, (n, d)).astype(np.float32)
            idx = HNSWIndex.build(vecs, HNSWConfig(dims=d, m=16), method="native",
                                  device="cpu")
            g = idx.graph
            q = torch.from_numpy(rng.integers(-6, 7, (4, d)).astype(np.float32))
            allow = g.valid & torch.from_numpy(rng.random(g.capacity) > 0.2)
            seeds0 = torch.from_numpy(rng.integers(0, n, (4, 3)).astype(np.int32))
            seeds0[2, 1:] = -1
            upper = torch.nonzero(g.levels >= 1)[:, 0].to(torch.int32)
            seeds1 = upper[torch.from_numpy(rng.integers(0, upper.numel(), 4))]
            built[n, d] = idx, q, allow, seeds0, seeds1
        return built[n, d]

    return get


def _run_emulated(emulated, monkeypatch, g, cfg, q, allow, seeds, ef, E, level, dual, hist,
                  wide=False, want_wide=None):
    """The emulated kernel through `_beam_launch`, held equal to the plain
    loop; `want_wide` is the layout the wrapper must pick. In the wide
    layout each query's candidate ids must end in its own slice of the
    workspace: the emulation runs blocks one after another, so slices that
    overlapped would go unseen otherwise."""
    qn = (q * q).sum(-1)
    seed_d = tgather.gather_distances(
        g.vectors, seeds if seeds.dim() == 2 else seeds[:, None], q, cfg.metric, qn
    ).reshape(seeds.shape)
    mi = 4 + (2 * ef) // E
    want = tsearch._beam_search_base_plain(g, cfg, q, seeds, seed_d, ef, allow, E, mi, level,
                                           qn, dual, hist)
    fn = emulation.entry(emulated["beam"], tsearch._BEAM)
    launched = []

    def launch(operands, *args):
        assert fn(*args, None) == 0
        launched.append((operands, args))

    monkeypatch.setattr(tsearch._BEAM, "launch", launch)
    pools = tsearch._seed_pools(q, seeds, seed_d, ef, allow)
    res_d, res_i, cand_i, counters = tsearch._beam_launch(
        g, cfg, q, qn, pools, ef, allow, E, mi, level, dual, hist, _wide=wide)
    assert len(launched) == 1 and emulated["beam"].emu_divergence_count() == 0
    operands, args = launched[0]
    if want_wide is not None:
        assert args[-4] == int(want_wide)  # the layout the wrapper chose
    if args[-4]:
        # the slice of query b: ckey [P] f32, then cid [P] i32, ...
        P = 1 << (ef + E * (cfg.m0 if level == 0 else cfg.m) - 1).bit_length()
        slices = operands[-1].reshape(q.shape[0], -1)
        cids = slices[:, 4 * P:4 * P + 4 * ef].contiguous().view(torch.int32)
        np.testing.assert_array_equal(cids.numpy(), cand_i.numpy())
    np.testing.assert_array_equal(res_d.numpy(), want[0].numpy())  # NaN equals NaN here
    np.testing.assert_array_equal(res_i.numpy(), want[1].numpy())
    np.testing.assert_array_equal(cand_i.numpy(), want[2].numpy())
    assert (int(counters[0]), int(counters[1])) == (int(want[3][0]), int(want[3][1]))


@pytest.mark.parametrize("rows_d,storage,metric,dual,hist,E,level,ef", [
    pytest.param(None, *c, id="-".join(map(str, c))) for c in CASES] + [
    pytest.param(c[:2], *c[2:], id=f"n{c[0]}-d{c[1]}-" + "-".join(map(str, c[2:])))
    for c in WIDE_CASES])
def test_emulated_beam_kernel_equals_plain_loop(emulated, world, wide_world, monkeypatch, rows_d,
                                                storage, metric, dual, hist, E, level, ef):
    """The kernel equals the plain loop; `rows_d` (rows, d) names a graph
    of `wide_world`, whose rows take the staged route, else `world`'s."""
    idx, q, allow, seeds0, seeds1 = world if rows_d is None else wide_world(*rows_d)
    cfg = HNSWConfig(dims=idx.config.dims, m=idx.config.m, metric=metric, storage_dtype=storage)
    g = idx.graph.clone()
    g.vectors = _tape(g, storage)
    staged = tsearch._BEAM.routed
    _run_emulated(emulated, monkeypatch, g, cfg, q, allow, seeds0 if level == 0 else seeds1,
                  ef, E, level, dual, hist, want_wide=False)
    assert tsearch._BEAM.routed - staged == (0 if rows_d is None else 1)


@pytest.mark.parametrize("storage,metric,dual,hist,E,level,ef",
                         [CASES[1], CASES[3], CASES[4], CASES[9]])
def test_emulated_beam_wide_layout_forced_equals_plain_loop(emulated, world, monkeypatch, storage,
                                                            metric, dual, hist, E, level, ef):
    """The wide layout (pools in the workspace), forced at shapes the
    shared layout also serves, gives what the plain loop gives."""
    idx, q, allow, seeds0, seeds1 = world
    cfg = HNSWConfig(dims=idx.config.dims, m=idx.config.m, metric=metric, storage_dtype=storage)
    g = idx.graph.clone()
    g.vectors = _tape(g, storage)
    _run_emulated(emulated, monkeypatch, g, cfg, q, allow, seeds0 if level == 0 else seeds1,
                  ef, E, level, dual, hist, wide=True, want_wide=True)


@pytest.fixture(scope="module")
def small_world():
    """Two small integer-valued indexes: m=16 over 300 rows for pools far
    wider than the graph, m=64 (m0=128) over 500 rows for more neighbour
    slots a pick than a block has threads."""
    rng = np.random.default_rng(8)
    d = 16
    out = []
    for n, m in ((300, 16), (500, 64)):
        vecs = rng.integers(-6, 7, (n, d)).astype(np.float32)
        idx = HNSWIndex.build(vecs, HNSWConfig(dims=d, m=m), method="native", device="cpu")
        q = torch.from_numpy(rng.integers(-6, 7, (2, d)).astype(np.float32))
        seeds = torch.from_numpy(rng.integers(0, n, (2, 2)).astype(np.int32))
        allow = idx.graph.valid & torch.from_numpy(rng.random(idx.capacity) > 0.2)
        out.append((idx, q, seeds, allow))
    return out


@pytest.mark.parametrize("dual", [True, False])
def test_emulated_beam_ef_8161_takes_the_wide_layout(emulated, small_world, monkeypatch, dual):
    """ef = 8,161 at m0 = 32 doubles the merge buffer to 16,384 slots: two
    pools then pass a block's 227 KB and the wrapper takes the wide
    layout by itself; one pool still fits."""
    idx, q, seeds, allow = small_world[0]
    g, cfg = idx.graph, idx.config
    ef = 8161
    wide = tsearch.beam_smem_bytes(ef, 1, cfg.m0, cfg.dims, 4 + 2 * ef, dual, True) \
        > tsearch._BEAM_MAX_SMEM
    assert wide == dual
    _run_emulated(emulated, monkeypatch, g, cfg, q, allow, seeds, ef, 1, 0, dual, True,
                  want_wide=wide)


@pytest.mark.parametrize("wide", [False, True])
def test_emulated_beam_more_slots_than_threads(emulated, small_world, monkeypatch, wide):
    """E * m0 = 9 * 128 = 1,152 neighbour slots a step, over the 256
    threads of a block: each thread strides over its slots."""
    idx, q, seeds, allow = small_world[1]
    g, cfg = idx.graph, idx.config
    _run_emulated(emulated, monkeypatch, g, cfg, q, allow, seeds, 48, 9, 0, True, True,
                  wide=wide, want_wide=wide)


LAYOUT_CASES = [
    (64, 1, 32, 128, False, True), (64, 1, 32, 128, True, True), (16, 1, 32, 100, False, True),
    (128, 4, 32, 128, False, False), (8161, 1, 32, 128, True, True), (10485, 1, 32, 128, False, True),
    (24, 2, 5, 19, True, True), (48, 9, 128, 16, True, False), (16384, 1, 32, 960, True, True)]
# the staged route's rows (512 bytes or more): the graph cells' serving
# shapes, E=4, f32 and bf16 tapes, a pool that leaves room for one row only,
# and rows so wide that one staged row would pass a block's 227 KB, which
# keep direct loads
STAGED_LAYOUT_CASES = [
    (64, 1, 32, 960, False, True, "int8"), (64, 1, 32, 1536, False, True, "int8"),
    (128, 4, 32, 1536, True, True, "int8"), (64, 1, 32, 128, True, True, "f32"),
    (64, 2, 32, 960, True, False, "bf16"), (3000, 1, 32, 1536, True, True, "int8"),
    (64, 1, 32, 8192, False, True, "f32"), (64, 1, 32, 40000, False, True, "f32"),
    (64, 1, 32, 55008, True, True, "int8")]


@pytest.mark.parametrize("ef,E,fan,d,dual,hist,storage", [
    pytest.param(*c, "int8", id="-".join(map(str, c))) for c in LAYOUT_CASES] + [
    pytest.param(*c, id="-".join(map(str, c))) for c in STAGED_LAYOUT_CASES])
def test_emulated_beam_layout_bytes_equal_the_wrappers(emulated, ef, E, fan, d, dual, hist,
                                                       storage):
    """`beam_smem_bytes` and `beam_pool_bytes` count what the layout of
    `csrc/beam.cu` (`vss_beam_layout_bytes`) counts, in both layouts, over
    each tape dtype."""
    import ctypes

    fn = emulated["beam"].vss_beam_layout_bytes
    fn.restype = None
    fn.argtypes = [ctypes.c_int32] * 9 + [ctypes.c_void_p]
    dtype = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}[storage]
    item = torch.empty((), dtype=dtype).element_size()
    mi = 4 + (2 * ef) // E
    out = (ctypes.c_int64 * 2)()
    for wide in (0, 1):
        fn(ef, E, fan, d, mi, int(dual), int(hist), wide, csrc.dtype_code(dtype),
           ctypes.addressof(out))
        want_pool = tsearch.beam_pool_bytes(ef, E, fan, d, mi, dual, hist) if wide else 0
        assert (out[0], out[1]) == (tsearch.beam_smem_bytes(
            ef, E, fan, d, mi, dual, hist, wide=bool(wide), itemsize=item), want_pool)


def test_emulated_beam_refuses_another_shared_memory_count(emulated, world, monkeypatch):
    """The entry point launches only when the wrapper's count of a block's
    shared memory equals the layout's own."""
    idx, q, allow, seeds0, _ = world
    g, cfg = idx.graph, idx.config
    qn = (q * q).sum(-1)
    seed_d = tgather.gather_distances(g.vectors, seeds0, q, cfg.metric, qn)
    fn = emulation.entry(emulated["beam"], tsearch._BEAM)
    codes = []
    monkeypatch.setattr(tsearch._BEAM, "launch", lambda operands, *args: codes.append(fn(*args, None)))
    right = tsearch.beam_smem_bytes
    for off in (0, 16):
        monkeypatch.setattr(tsearch, "beam_smem_bytes", lambda *a, **k: right(*a, **k) + off)
        tsearch._beam_launch(g, cfg, q, qn, tsearch._seed_pools(q, seeds0, seed_d, 16, allow),
                             16, allow, 1, 36, 0, True, True)
    assert codes[0] == 0 and codes[1] != 0


@pytest.mark.parametrize("storage,d", [("f32", 24), ("int8", 48), ("bf16", 16), ("f32", 19)])
@pytest.mark.parametrize("metric", ["l2sq", "ip"])
def test_emulated_k1_equals_plain(emulated, storage, d, metric):
    rng = np.random.default_rng(d)
    table = torch.from_numpy(rng.integers(-6, 7, (300, d)).astype(np.float32))
    table = table.to({"f32": torch.float32, "int8": torch.int8, "bf16": torch.bfloat16}[storage])
    q = torch.from_numpy(rng.integers(-6, 7, (5, d)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-1, 300, (5, 21)).astype(np.int32))
    qn = (q * q).sum(-1)
    want = tgather._gather_distances_plain(table, ids, q, tgather.Metric.parse(metric), qn)
    out = torch.empty((5, 21), dtype=torch.float32)
    fn = emulation.entry(emulated["gather"], tgather._K1)
    assert fn(ids.data_ptr(), q.data_ptr(), qn.data_ptr(), table.data_ptr(), out.data_ptr(),
              5, 21, d, csrc.dtype_code(table.dtype), tgather.METRIC_IDS[
                  tgather.Metric.parse(metric)], None) == 0
    assert emulated["gather"].emu_divergence_count() == 0
    np.testing.assert_array_equal(out.numpy(), want.numpy())


@pytest.mark.parametrize("dtype,row,skip_neg", [
    (torch.int32, 32, False), (torch.int8, 100, True), (torch.float32, 33, False),
    (torch.int8, 99, True)])
def test_emulated_k5_equals_plain(emulated, dtype, row, skip_neg):
    rng = np.random.default_rng(row)
    table = torch.from_numpy(rng.integers(-100, 100, (200, row))).to(dtype)
    ids = torch.from_numpy(rng.integers(-2, 200, (37,)).astype(np.int32))
    want = tgather._gather_rows_plain(table, ids, skip_neg)
    out = torch.empty((37, row), dtype=dtype)
    fn = emulation.entry(emulated["gather"], tgather._K5)
    assert fn(ids.data_ptr(), table.data_ptr(), out.data_ptr(), 37, row * table.element_size(),
              int(skip_neg), None) == 0
    np.testing.assert_array_equal(out.numpy(), want.numpy())
