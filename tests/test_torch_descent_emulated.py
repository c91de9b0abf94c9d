"""The CUDA source of the `greedy_descent` kernel (`csrc/descent.cu`),
compiled with g++ and run on the CPU, against its plain version
`_greedy_descent_plain`, the lockstep loop through K1 and K5.

There is no nvcc and no card where these tests run, so the kernel itself
is held against the plain loop only on the card (`chip_smoke.py`,
`check_descent`). What runs here is its C++: `tests/cuda_emulation.h`
stands in for the CUDA headers and runs a block's threads as cooperative
fibers that switch at every barrier and warp exchange; `tests/emulation.py`
turns the `<<<...>>>` launch into a call and the dynamic shared memory
into a pointer, and changes nothing else.

Inputs are integer-valued, so every f32 sum is exact in any order and the
kernel must equal the plain loop exactly: the node reached, its distance
to the last bit (NaN equal to NaN), and the three counters (steps, tape
rows scored, adjacency rows read). The emulation shows what the kernel
computes, never how fast, and it cannot show a missing barrier.
"""
import shutil

import numpy as np
import pytest
import torch

import emulation
import vss_tpu_torch.index.search as tsearch
from vss_tpu_torch import HNSWConfig, HNSWIndex
from vss_tpu_torch.index.graph import empty_graph, sample_levels

_TAPES = {"f32": torch.float32, "int8": torch.int8, "bf16": torch.bfloat16}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """libdescent built by g++ from csrc/descent.cu."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    work = tmp_path_factory.mktemp("cuda_emulation")
    emulation.setup(work)
    return emulation.build(work, ("descent",))["descent"]


def _index(seed, n, d, m):
    rng = np.random.default_rng(seed)
    vecs = rng.integers(-6, 7, (n, d)).astype(np.float32)
    idx = HNSWIndex.build(vecs, HNSWConfig(dims=d, m=m), method="native", device="cpu")
    q = torch.from_numpy(rng.integers(-6, 7, (8, d)).astype(np.float32))
    q[5, 3] = float("nan")  # a NaN query: every distance NaN, no move
    q[6] = 0  # a zero query (the cosine guards)
    return idx, q


@pytest.fixture(scope="module")
def world():
    """900 integer-valued rows of d=24, m=6: one round of lane groups."""
    return _index(11, 900, 24, 6)


@pytest.fixture(scope="module")
def wide_world():
    """m=48 over 1,200 int8-valued rows of d=128 (16 groups of 8 lanes:
    three rounds a step), the iid arm's m."""
    return _index(12, 1200, 128, 48)


def _graph(idx, storage):
    g = idx.graph.clone()
    g.vectors = g.vectors.to(_TAPES[storage])
    return g


def _stops(g, kind, B):
    top = int(g.max_level)
    if kind == "zero":
        return 0
    if kind == "wave":  # drawn as a wave draws its nodes' levels
        return torch.from_numpy(sample_levels(B, HNSWConfig(dims=24, m=6), seed=5))
    return torch.tensor([0, 1, top + 1, top, 0, 1, 0, max(top - 1, 0)][:B], dtype=torch.int32)


def _run(lib, monkeypatch, g, cfg, q, stop, max_iters=0, q_norms=None):
    """The emulated kernel through `_descent_launch`, held equal to the
    plain loop; returns the plain loop's (cur, cur_d, counters)."""
    mi = tsearch._descent_iters(cfg, max_iters)
    visits = []
    want = tsearch._greedy_descent_plain(g, cfg, q, stop, mi, q_norms, visits)
    want = (*want, tsearch._descent_counters(visits))
    fn = emulation.entry(lib, tsearch._DESCENT)
    launched = []

    def launch(operands, *args):
        assert fn(*args, None) == 0
        launched.append(args)

    monkeypatch.setattr(tsearch._DESCENT, "launch", launch)
    cur, cur_d, counters = tsearch._descent_launch(g, cfg, q, stop, mi, q_norms)
    assert len(launched) == int(q.shape[0] > 0)
    assert lib.emu_divergence_count() == 0
    np.testing.assert_array_equal(cur.numpy(), want[0].numpy())
    np.testing.assert_array_equal(cur_d.numpy(), want[1].numpy())  # NaN equals NaN here
    assert [int(c) for c in counters] == list(want[2])
    return want


CASES = [
    # storage, metric, stops, max_iters
    ("f32", "l2sq", "zero", 0),
    ("f32", "l2sq", "per_query", 0),
    ("f32", "ip", "zero", 0),
    ("f32", "cosine", "per_query", 0),
    ("int8", "l2sq", "zero", 0),
    ("int8", "ip", "per_query", 0),
    ("int8", "cosine", "zero", 0),
    ("int8", "l2sq", "wave", 0),
    ("bf16", "l2sq", "per_query", 0),
    ("f32", "l2sq", "zero", 1),
    ("int8", "l2sq", "per_query", 2),
    ("f32", "cosine", "zero", 2),
]


@pytest.mark.parametrize("storage,metric,stops,max_iters", CASES)
def test_emulated_descent_equals_plain_loop(emulated, world, monkeypatch, storage, metric,
                                            stops, max_iters):
    idx, q = world
    cfg = HNSWConfig(dims=idx.config.dims, m=idx.config.m, metric=metric, storage_dtype=storage)
    g = _graph(idx, storage)
    cur, cur_d, (steps, scored, adj_rows) = _run(
        emulated, monkeypatch, g, cfg, q, _stops(g, stops, q.shape[0]), max_iters)
    assert int(g.max_level) >= 2 and scored > 0 and adj_rows > 0
    if max_iters:
        assert steps == max_iters
    # the NaN query never moves from the entry: its distances are NaN (under
    # cosine the zero-norm guard makes them all 1, a tie that never improves)
    assert int(cur[5]) == int(g.entry)
    assert bool(cur_d[5].isnan()) == (metric != "cosine")


@pytest.mark.parametrize("storage,q_norms", [("int8", False), ("f32", True)])
def test_emulated_descent_more_neighbours_than_lane_groups(emulated, wide_world, monkeypatch,
                                                           storage, q_norms):
    """M past one round of lane groups: m=48 over int8 rows of 128 B (16
    groups of 8 lanes, three rounds a step) and over f32 rows of 512 B (4
    groups of 32 lanes, twelve rounds)."""
    idx, q = wide_world
    cfg = HNSWConfig(dims=128, m=48, storage_dtype=storage)
    g = _graph(idx, storage)
    qn = (q * q).sum(-1) if q_norms else None
    _, _, (steps, scored, _) = _run(emulated, monkeypatch, g, cfg, q, _stops(g, "per_query", 8),
                                    q_norms=qn)
    assert g.upper_adj.shape[1] == 48 and steps > 0 and scored > 0


def _level1_row(idx, storage):
    """A clone that starts its descent at level 1 (max_level set to 1), and
    the valid ids of the entry's level-1 adjacency row."""
    g = _graph(idx, storage)
    g.max_level = torch.tensor(1, dtype=torch.int32)
    ids = g.upper_adj[int(g.upper_row[int(g.entry), 0])]
    return g, ids[ids >= 0]


@pytest.mark.parametrize("wide", [False, True])
def test_emulated_descent_ties_take_the_first_neighbour(emulated, world, wide_world, monkeypatch,
                                                        wide):
    """Every neighbour in the entry's level-1 row gets the same vector, the
    query's own: the argmin takes the first of the tied positions, across
    the lane groups and (m=48: three rounds a step) within a group, and no
    later step moves (a tie does not improve)."""
    idx, q = wide_world if wide else world
    g, ids = _level1_row(idx, "f32")
    assert ids.numel() > (16 if wide else 1)
    g.vectors[ids.long()] = q[0]
    cur, cur_d, _ = _run(emulated, monkeypatch, g, idx.config, q[:1].clone(), 0)
    assert int(cur[0]) == int(ids[0]) and float(cur_d[0]) == 0.0


def test_emulated_descent_nan_distance_drops_a_level(emulated, world, monkeypatch):
    """A NaN row among the neighbours: the argmin takes the NaN (as
    torch.argmin does) over a nearer row, so the step does not move and the
    query drops a level."""
    idx, q = world
    g, ids = _level1_row(idx, "f32")
    g.vectors[ids[0].long()] = q[0]
    g.vectors[ids[1].long(), 2] = float("nan")
    cur, _, (steps, _, _) = _run(emulated, monkeypatch, g, idx.config, q[:1].clone(), 0)
    assert int(cur[0]) == int(g.entry) and steps == 1


def test_emulated_descent_adjacency_padding_and_missing_rows(emulated, world, monkeypatch):
    """-1 ids padding the adjacency rows (no load, +inf) and -1 entries of
    upper_row (an inactive step: a level drop)."""
    idx, q = world
    g = _graph(idx, "int8")
    cfg = HNSWConfig(dims=24, m=6, storage_dtype="int8")
    g.upper_adj[::2, 2:] = -1
    g.upper_adj[1::3, :1] = -1
    upper = torch.nonzero(g.levels >= 1)[:, 0]
    g.upper_row[upper[::3], 0] = -1
    _, _, (steps, scored, adj_rows) = _run(emulated, monkeypatch, g, cfg, q,
                                           _stops(g, "zero", 8))
    assert steps > 0 and scored < adj_rows * 6


@pytest.mark.parametrize("stops", ["zero", "per_query"])
def test_emulated_descent_graph_of_one_level(emulated, world, monkeypatch, stops):
    """max_level 0: no step; every query stays at the entry."""
    idx, q = world
    g = _graph(idx, "f32")
    g.max_level = torch.tensor(0, dtype=torch.int32)
    cur, _, counters = _run(emulated, monkeypatch, g, idx.config, q, _stops(g, stops, 8))
    assert counters == (0, 0, 0) and (cur == int(g.entry)).all()


@pytest.mark.parametrize("metric", ["l2sq", "cosine"])
def test_emulated_descent_empty_graph(emulated, world, monkeypatch, metric):
    """entry = -1, max_level = -1: every query ends at slot 0, scored
    against its zero row."""
    _, q = world
    cfg = HNSWConfig(dims=24, m=6, metric=metric)
    g = empty_graph(cfg, 64, device="cpu")
    cur, _, counters = _run(emulated, monkeypatch, g, cfg, q, 0)
    assert int(g.entry) == -1 and counters == (0, 0, 0) and (cur == 0).all()


def test_emulated_descent_empty_batch(emulated, world, monkeypatch):
    idx, q = world
    _run(emulated, monkeypatch, _graph(idx, "f32"), idx.config, q[:0], 0)


def test_emulated_descent_refuses_shapes_it_cannot_take(emulated, world):
    """M, d or max_iters below 1, or a query past a block's shared memory:
    the entry point returns an error and launches nothing."""
    idx, q = world
    g = _graph(idx, "f32")
    fn = emulation.entry(emulated, tsearch._DESCENT)
    cur = torch.full((8,), -7, dtype=torch.int32)
    cur_d = torch.full((8,), -7.0)
    counters = torch.zeros(3, dtype=torch.int64)
    stop = torch.zeros(8, dtype=torch.int32)
    qn = (q * q).sum(-1)
    ptrs = [q.data_ptr(), qn.data_ptr(), g.vectors.data_ptr(), g.upper_row.data_ptr(),
            g.upper_adj.data_ptr(), g.entry.data_ptr(), g.max_level.data_ptr(),
            stop.data_ptr(), cur.data_ptr(), cur_d.data_ptr(), counters.data_ptr()]
    lmax = g.upper_row.shape[1]
    for M, d, max_iters in ((0, 24, 8), (6, 0, 8), (6, 24, 0), (6, 60000, 8)):
        assert fn(*ptrs, 8, M, d, lmax, 0, 0, max_iters, None) != 0
    assert (cur == -7).all() and (cur_d == -7.0).all() and (counters == 0).all()
    assert fn(*ptrs, 8, 6, 24, lmax, 0, 0, 8, None) == 0
    assert (cur >= 0).all()


def test_descent_wrapper_refuses_a_graph_it_cannot_read(world):
    idx, q = world
    g = _graph(idx, "f32")
    g.upper_adj = g.upper_adj.long()
    with pytest.raises(ValueError, match="greedy_descent"):
        tsearch._descent_launch(g, idx.config, q, 0, 8, None)


def test_greedy_descent_on_cpu_runs_the_plain_loop(world):
    idx, q = world
    g = _graph(idx, "f32")
    stop = _stops(g, "per_query", 8)
    cur, cur_d = tsearch.greedy_descent(g, idx.config, q, stop)
    want = tsearch._greedy_descent_plain(g, idx.config, q, stop,
                                         tsearch._descent_iters(idx.config, 0), None)
    np.testing.assert_array_equal(cur.numpy(), want[0].numpy())
    np.testing.assert_array_equal(cur_d.numpy(), want[1].numpy())



def test_descent_kernel_is_registered():
    """The kernel is built from csrc/descent.cu at first use like the
    others, and its launches are counted under its name."""
    from vss_tpu_torch import csrc

    assert csrc.SOURCES["descent"] == "descent.cu"
    assert csrc.KERNELS["greedy_descent"] is tsearch._DESCENT
    assert tsearch._DESCENT.library == "descent"
