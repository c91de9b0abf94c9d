"""The CUDA source of the `select_neighbors` kernel (`csrc/select.cu`),
compiled with g++ and run on the CPU, against its plain version
`_select_neighbors_plain`.

There is no nvcc and no card where these tests run, so the kernel itself
is held against the plain version only on the card (`chip_smoke.py`,
`check_select`). What runs here is its C++: `tests/cuda_emulation.h`
stands in for the CUDA headers and runs a block's threads as cooperative
fibers that switch at every barrier and warp exchange; `tests/emulation.py`
turns the `<<<...>>>` launch into a call and the dynamic shared memory
into a pointer, and changes nothing else.

Vectors are integer-valued, so every f32 dot product and norm is exact in
any order of the sums and the kernel must equal the plain version id for
id: int8, bf16 and f32 tapes under l2sq, ip and cosine; fewer candidates
than slots (padding), 32 to 144 candidates, 16 to 96 slots; `active`
masks; ids of -1 with a finite distance; NaN, +-inf, equal and signed-zero
distances; zero rows under cosine; a NaN row; candidate vectors given by
the caller; each of the kernel's three layouts; an empty batch. Two
mutants of the kernel (ties in the wrong order, a minimum that drops NaN)
must each fail a case. An insert wave with the emulated kernel in place of
`select_neighbors` must equal `vss_tpu`'s `insert_wave` array for array.
The emulation shows what the kernel computes, never how fast, and it
cannot show a missing barrier.
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emulation
import vss_tpu.index.build as jbuild
import vss_tpu_torch.index.build as tbuild
import vss_tpu_torch.index.select as tselect
from vss_tpu.index.graph import HNSWConfig as JConfig
from vss_tpu.index.graph import HNSWGraph as JGraph
from vss_tpu.index.graph import sample_levels as jax_sample_levels
from vss_tpu.index.host_build import build_host_graph as jax_build_host_graph
from vss_tpu.index.host_build import host_graph_to_device as jax_host_graph_to_device
from vss_tpu_torch import csrc
from vss_tpu_torch.convert import GRAPH_FIELDS, graph_from_arrays
from vss_tpu_torch.index.graph import HNSWConfig as TConfig
from vss_tpu_torch.ops.distance import gathered_distances

_TAPES = {"f32": torch.float32, "int8": torch.int8, "bf16": torch.bfloat16}
# the two mutants: ties of both sorts in reverse position order; a
# minimum over the kept candidates that drops NaN (fminf) where the plain
# version's torch.amin keeps it
_MUTANTS = {
    "ties_last": ("(kj == kc && j < c)", "(kj == kc && j > c)"),
    "nan_dropped": ("nan_min(dmin[t], ", "fminf(dmin[t], "),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several workers share the machine: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(tmp_path_factory, edits=()):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    work = tmp_path_factory.mktemp("cuda_emulation")
    emulation.setup(work)
    return emulation.build(work, ("select",), edits)["select"]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """libselect built by g++ from csrc/select.cu."""
    return _build(tmp_path_factory)


@pytest.fixture(scope="module", params=sorted(_MUTANTS))
def mutant(request, tmp_path_factory):
    return request.param, _build(tmp_path_factory, [_MUTANTS[request.param]])


def _case(seed, storage="f32", metric="l2sq", A=10, C=48, m=16, d=24, n=400, lo=-6, hi=6,
          active=False, vecs=None):
    """Integer-valued tape rows and queries, pre-deduplicated candidate
    lists with their distances to the queries, and the edge cases on the
    first rows. `vecs` "same": the caller's candidate vectors are the
    tape's rows; "other": they are rows of another tape (the kernel must
    read them, not the tape)."""
    rng = np.random.default_rng(seed)
    tape = rng.integers(lo, hi + 1, (n, d)).astype(np.float32)
    tape[3:5] = 0  # zero rows (the cosine guards)
    q = rng.integers(lo, hi + 1, (A, d)).astype(np.float32)
    if A > 5:
        q[5] = 0  # a zero query
    pool = np.setdiff1d(np.arange(n), [3, 4])
    cand_i = np.zeros((A, C), np.int32)
    for row in cand_i:
        row[:] = rng.choice(pool, C, replace=False)
    special = A >= 8 and C >= 12
    if special:
        cand_i[6, :2] = [3, 4]  # both zero rows in one list
        cand_i[0, [1, 4]] = -1  # -1 ids: their finite distances become +inf
        cand_i[1] = -1  # an empty list
    vectors = torch.from_numpy(tape).to(_TAPES[storage])
    ids = torch.from_numpy(cand_i)
    cand_vecs = None
    if vecs == "same":
        cand_vecs = vectors[ids.clamp(min=0).long()]
    elif vecs == "other":
        other = rng.integers(lo, hi + 1, (n, d)).astype(np.float32)
        cand_vecs = torch.from_numpy(other).to(_TAPES[storage])[ids.clamp(min=0).long()]
        vectors = torch.zeros_like(vectors)
    rows = (cand_vecs if cand_vecs is not None else vectors[ids.clamp(min=0).long()]).float()
    cand_d = gathered_distances(torch.from_numpy(q), rows, metric)
    if special:
        cand_d[2, [0, 7]] = float("nan")
        cand_d[2, 3] = float("inf")
        cand_d[2, 5] = -float("inf")
        cand_d[3, 2:12] = cand_d[3, 2]  # equal distances, different vectors
        cand_d[4, [1, 6, 9]] = torch.tensor([-0.0, 0.0, -0.0])
    act = None
    if active:
        act = torch.from_numpy(rng.random(A) < 0.6)
        act[0] = True
    return dict(q_vecs=torch.from_numpy(q), cand_i=ids, cand_d=cand_d.contiguous(),
                vectors=vectors, m=m, metric=metric, active=act, cand_vecs=cand_vecs)


def _use(lib, monkeypatch) -> list:
    """Route `_select_launch` to the emulated library: its launches to the
    emulated entry point, its size query to the emulated library's.
    Returns the list the launches' arguments are appended to."""
    fn = emulation.entry(lib, tselect._SELECT)
    launched = []

    def launch(operands, *args):
        assert fn(*args, None) == 0
        launched.append(args)

    monkeypatch.setattr(tselect._SELECT, "launch", launch)
    monkeypatch.setattr(csrc, "load", lambda name: {"select": lib}[name])
    return launched


def _layout(lib, Cp, d, esize) -> int:
    fn = lib.vss_select_layout
    fn.restype = csrc.I32
    fn.argtypes = [csrc.I32] * 3
    return fn(Cp, d, esize)


def _run(lib, monkeypatch, case, layout=None):
    """The emulated kernel through `_select_launch`; returns (its ids, the
    plain version's ids, launches)."""
    launched = _use(lib, monkeypatch)
    want = tselect._select_neighbors_plain(**case)
    got = tselect._select_launch(case["cand_i"], case["cand_d"], case["vectors"], case["m"],
                                 case["metric"], case["active"], case["cand_vecs"],
                                 layout=layout)
    assert lib.emu_divergence_count() == 0
    return got, want, len(launched)


def _check(lib, monkeypatch, case, layout=None):
    got, want, launches = _run(lib, monkeypatch, case, layout)
    A = case["cand_i"].shape[0]
    assert launches == int(A > 0)
    assert got.dtype == torch.int32 and got.shape == (A, case["m"])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    return got


CASES = [
    # storage, metric, C, m, d, integer range
    ("f32", "l2sq", 48, 16, 24, 6),
    ("f32", "ip", 32, 16, 24, 6),
    ("f32", "cosine", 48, 16, 24, 6),
    ("int8", "l2sq", 144, 16, 128, 127),  # the insert wave's shape
    ("int8", "cosine", 144, 16, 128, 127),
    ("int8", "ip", 48, 32, 128, 127),  # the base back-links' shape
    ("bf16", "l2sq", 48, 32, 40, 6),
    ("bf16", "cosine", 32, 16, 24, 6),
    ("bf16", "ip", 144, 16, 32, 6),
    ("f32", "l2sq", 13, 16, 24, 6),  # C = m - 3: padding
    ("int8", "ip", 29, 32, 24, 100),
    ("int8", "l2sq", 144, 96, 32, 100),  # m0 = 96 (M = 48)
    ("f32", "cosine", 93, 96, 20, 6),
    ("f32", "l2sq", 144, 32, 20, 6),
]


@pytest.mark.parametrize("storage,metric,C,m,d,hi", CASES)
def test_emulated_select_equals_plain(emulated, monkeypatch, storage, metric, C, m, d, hi):
    case = _case(C * 7 + m + d, storage, metric, C=C, m=m, d=d, lo=-hi, hi=hi)
    got = _check(emulated, monkeypatch, case)
    assert (got[1] == -1).all() and (got[0] >= 0).any()
    # the heuristic pruned some and filled from the pruned list
    assert (got >= 0).sum() > 0


@pytest.mark.parametrize("storage,metric,C,m", [
    ("int8", "l2sq", 144, 16), ("f32", "cosine", 13, 16), ("bf16", "ip", 48, 32)])
def test_emulated_select_active_rows(emulated, monkeypatch, storage, metric, C, m):
    case = _case(5, storage, metric, C=C, m=m, d=32, active=True)
    got = _check(emulated, monkeypatch, case)
    assert (got[~case["active"]] == -1).all() and (got[case["active"]] >= 0).any()


@pytest.mark.parametrize("vecs,storage,C", [
    ("same", "f32", 48), ("other", "f32", 48), ("other", "int8", 144), ("other", "bf16", 13)])
def test_emulated_select_given_candidate_vectors(emulated, monkeypatch, vecs, storage, C):
    """cand_vecs [A, C, d] in place of the tape's rows (the bulk builder's
    back-links pass them); with "other" they are not the tape's rows, so
    a kernel that read the tape would differ."""
    case = _case(6, storage, "l2sq", C=C, m=16, d=32, vecs=vecs, active=True)
    _check(emulated, monkeypatch, case)


def test_emulated_select_nan_row_rejects_the_rest(emulated, monkeypatch):
    """A kept candidate whose row holds a NaN: its distance to every later
    candidate is NaN, the minimum over the kept is NaN (torch.amin), and
    nothing more is kept; the rest of the row is the pruned fill."""
    case = _case(7, "f32", "l2sq", A=4, C=32, m=16)
    case["vectors"][int(case["cand_i"][0, 5]), 3] = float("nan")
    case["cand_d"][0, 5] = -1.0  # first in the order: kept
    got = _check(emulated, monkeypatch, case)
    assert int(got[0, 0]) == int(case["cand_i"][0, 5])


@pytest.mark.parametrize("metric", ["l2sq", "cosine"])
def test_emulated_select_row_too_wide_for_shared_memory(emulated, monkeypatch, metric):
    """48 f32 rows of d=1,200 (225 KB) with the per-candidate arrays pass a
    block's 227 KB: the rows are read from device memory."""
    case = _case(8, "f32", metric, A=8, C=48, m=16, d=1200)
    assert _layout(emulated, 48, 1200, 4) == tselect._ROWS_GLOBAL
    _check(emulated, monkeypatch, case)


def test_emulated_select_many_candidates(emulated, monkeypatch):
    """9,000 candidates: the per-candidate arrays alone pass a block's
    shared memory and move to the workspace in device memory."""
    case = _case(9, "f32", "l2sq", A=2, C=9000, m=16, d=4, n=10000, lo=-40, hi=40)
    assert _layout(emulated, 9000, 4, 4) == tselect._ALL_GLOBAL
    _check(emulated, monkeypatch, case)


@pytest.mark.parametrize("layout", [0, 1, 2])
def test_emulated_select_each_layout(emulated, monkeypatch, layout):
    """Each layout forced at the insert wave's shape (int8, 144 x 16)."""
    case = _case(10, "int8", "l2sq", A=9, C=144, m=16, d=128, lo=-127, hi=127, active=True)
    _check(emulated, monkeypatch, case, layout=layout)


@pytest.mark.parametrize("C", [0, 48])
def test_emulated_select_empty(emulated, monkeypatch, C):
    """An empty batch launches nothing; an empty candidate list gives all
    -1."""
    case = _case(11, "f32", "l2sq", A=0 if C else 3, C=C, m=16)
    _check(emulated, monkeypatch, case)


@pytest.mark.parametrize("Cp,d,esize,layout", [
    (144, 128, 1, 0),  # the insert wave's shape
    (48, 128, 4, 0),  # the bulk builder's back-links
    (48, 960, 1, 0),  # the gist width, int8 tape
    (48, 960, 4, 0),  # the gist width, f32 rows: 184 KB of rows, 190 KB in all
    (48, 1200, 4, 1),
    (144, 1040, 2, 1),
    (9000, 4, 4, 2),
])
def test_layout_and_workspace_chosen_by_the_kernel(emulated, Cp, d, esize, layout):
    """The entry point's choice when none is forced: the first layout whose
    shared memory fits a block; only the all-global layout needs a
    workspace, of the bytes its rows need."""
    assert _layout(emulated, Cp, d, esize) == layout
    ws = emulated.vss_select_workspace_bytes
    ws.restype = csrc.I64
    ws.argtypes = [csrc.I32] * 4
    assert ws(Cp, d, esize, -1) == (ws(Cp, d, esize, 2) if layout == 2 else 0)
    assert ws(Cp, d, esize, 0) == ws(Cp, d, esize, 1) == 0
    assert ws(Cp, d, esize, 2) >= 7 * 4 * Cp + Cp + 4 * d


def test_emulated_select_refuses_what_it_cannot_take(emulated):
    """m or d below 1, a layout whose shared memory passes 227 KB, the
    workspace layout without a workspace, a layout that does not exist:
    the entry point returns an error and launches nothing."""
    case = _case(12, "f32", "l2sq", A=4, C=48, m=16, d=1200)
    fn = emulation.entry(emulated, tselect._SELECT)
    out = torch.full((4, 16), -7, dtype=torch.int32)
    ptrs = [case["cand_i"].data_ptr(), case["cand_d"].data_ptr(), case["vectors"].data_ptr(),
            None, out.data_ptr(), None, 0]
    for m, d, layout in ((0, 1200, 1), (16, 0, 1), (16, 1200, 0), (16, 1200, 2), (16, 1200, -2)):
        assert fn(*ptrs, 4, 48, m, d, 0, 0, 0, layout, None) != 0
    assert (out == -7).all()
    assert fn(*ptrs, 4, 48, 16, 1200, 0, 0, 0, 1, None) == 0
    assert (out != -7).all()


def test_mutants_fail_a_case(mutant, monkeypatch):
    """Each mutant differs from the plain version on some case: ties in
    reverse order on the equal distances, the NaN-dropping minimum on the
    NaN row."""
    name, lib = mutant
    case = _case(15, "f32", "l2sq", C=48, m=16, d=24)
    if name == "nan_dropped":
        case["vectors"][int(case["cand_i"][0, 5]), 3] = float("nan")
        case["cand_d"][0, 5] = -1.0
    got, want, _ = _run(lib, monkeypatch, case)
    assert not torch.equal(got, want)


def test_emulated_select_in_an_insert_wave_equals_vss_tpu(emulated, monkeypatch):
    """One wave of 64 rows (d=16, M=8) into a 200-row host-built graph,
    with the emulated kernel in place of every `select_neighbors` call of
    the port's `insert_wave` (the wave's selection and the back-links'
    re-selection at each level): every graph array equals `vss_tpu`'s
    outside the scatter sinks."""
    D, W, EFC, M, CAP = 16, 64, 32, 8, 264
    kw = dict(dims=D, m=M, ef_construction=EFC)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    rng = np.random.default_rng(0)
    host = jax_host_graph_to_device(
        jax_build_host_graph(rng.integers(-8, 9, (200, D)).astype(np.float32), jcfg, seed=0),
        capacity=CAP)
    arrays = {f: np.asarray(getattr(host, f)) for f in GRAPH_FIELDS}
    used = int(arrays["levels"].sum())
    arrays["upper_adj"] = np.concatenate([arrays["upper_adj"], np.full((64, M), -1, np.int32)])
    n_valid = W - 5
    levels = np.zeros(W, np.int32)
    levels[:n_valid] = jax_sample_levels(n_valid, jcfg, 3)
    urows, _ = jbuild.plan_wave_rows(levels, used, jcfg.max_levels)
    wave = (rng.integers(-8, 9, (W, D)).astype(np.float32), np.arange(200, 200 + W, dtype=np.int32),
            levels, urows, np.where(np.arange(W) < n_valid, 1000 + np.arange(W), -1).astype(np.int32),
            np.arange(W) < n_valid)
    jg = jbuild.insert_wave(JGraph(**{f: jnp.asarray(a) for f, a in arrays.items()}), jcfg,
                            *(jnp.asarray(a) for a in wave), EFC, 4, M)

    launched = _use(emulated, monkeypatch)
    monkeypatch.setattr(tbuild, "select_neighbors", lambda q_vecs, *a, **k:
                        tselect._select_launch(*a, **k))
    tg = tbuild.insert_wave(graph_from_arrays(arrays, "cpu"), tcfg, *wave, EFC, 4, M)
    assert emulated.emu_divergence_count() == 0
    # two calls a level: the wave's selection and the back-links'
    assert len(launched) == 2 * (int(levels.max()) + 1)
    cap, ucap = CAP, arrays["upper_adj"].shape[0]
    for f in GRAPH_FIELDS:
        j, t = np.asarray(getattr(jg, f)), getattr(tg, f).numpy()
        if f == "upper_adj":
            j, t = j[:ucap - 1], t[:ucap - 1]
        elif j.ndim >= 1:
            j, t = j[:cap - 1], t[:cap - 1]
        np.testing.assert_array_equal(t, j, err_msg=f)
    assert bool((tg.adj0[:200] >= 200).any())


def test_select_neighbors_on_cpu_runs_the_plain_version(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel launched for CPU tensors")

    monkeypatch.setattr(tselect._SELECT, "launch", refuse)
    case = _case(13, "int8", "cosine", C=48, m=16, active=True)
    got = tselect.select_neighbors(**case)
    np.testing.assert_array_equal(got.numpy(), tselect._select_neighbors_plain(**case).numpy())


def test_select_kernel_is_registered():
    """The kernel is built from csrc/select.cu at first use like the
    others, and its launches are counted under its name."""
    assert csrc.SOURCES["select"] == "select.cu"
    assert csrc.KERNELS["select_neighbors"] is tselect._SELECT
    assert tselect._SELECT.library == "select"


def test_select_wrapper_refuses_shapes_that_disagree():
    case = _case(14, "f32", "l2sq", A=4, C=48, m=16)
    with pytest.raises(ValueError, match="select_neighbors"):
        tselect._select_launch(case["cand_i"], case["cand_d"][:, :40], case["vectors"], 16,
                               "l2sq")
