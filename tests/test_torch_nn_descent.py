"""vss_tpu_torch.index.nn_descent on the CPU.

The five tests of `tests/test_nn_descent.py`, ported: convergence from an
adversarial (random) seed, the exact_knn output contract, the seed's
quality kept, the adaptive trigger skipping good lists, tiny inputs
passed through. Then cross-package parity: both packages draw the same
recall sample and find the same oracle (real-valued data, so that no tie
can order the two oracles differently), and from the same seed lists run
the same rounds, so the refined lists are equal on integer-valued vectors
(exact f32 distances, ties to the lower position in both).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vss_tpu.index.nn_descent import nn_descent_refine as j_nnd
from vss_tpu.index.nn_descent import sampled_list_recall as j_recall
from vss_tpu_torch.index.exact_build import exact_knn
from vss_tpu_torch.index.nn_descent import nn_descent_refine, sampled_list_recall
from vss_tpu_torch.ops.distance import gathered_distances


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_seed_lists(xv, C, rng):
    """Adversarial seed: uniformly random candidate ids (what IVF lists
    degenerate to on iid data), distances scored honestly, sorted."""
    n = xv.shape[0]
    ci = rng.integers(0, n, (n, C)).astype(np.int32)
    ci = np.where(ci == np.arange(n)[:, None], (ci + 1) % n, ci)
    cd = gathered_distances(xv, xv[torch.from_numpy(ci).long()], "l2sq").numpy()
    order = np.argsort(cd, axis=1, kind="stable")
    return (torch.from_numpy(np.take_along_axis(cd, order, 1)),
            torch.from_numpy(np.take_along_axis(ci, order, 1)))


@pytest.fixture(scope="module")
def iid_case():
    rng = np.random.default_rng(0)
    n, d, C = 6144, 32, 24
    xv = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    cd, ci = _random_seed_lists(xv, C, rng)
    return xv, cd, ci


def test_converges_from_random_seed(iid_case):
    xv, cd, ci = iid_case
    rec0, _, _ = sampled_list_recall(xv, ci, "l2sq", n_sample=256, seed=1)
    _, ni = nn_descent_refine(xv, cd, ci, "l2sq", chunk=1024, max_rounds=6,
                              target_recall=0.92, seed=3)
    rec1, _, _ = sampled_list_recall(xv, ni, "l2sq", n_sample=256, seed=1)
    assert rec0 < 0.05  # the seed really was garbage
    assert rec1 >= 0.85, f"NN-descent failed to converge: {rec0} -> {rec1}"


def test_output_contract(iid_case):
    xv, cd, ci = iid_case
    n = xv.shape[0]
    nd, ni = nn_descent_refine(xv, cd, ci, "l2sq", chunk=1024, max_rounds=2,
                               target_recall=0.99, seed=3)
    assert nd.shape == cd.shape and ni.shape == ci.shape
    assert nd.dtype == torch.float32 and ni.dtype == torch.int32
    nd, ni = nd.numpy(), ni.numpy()
    # no self-matches, ids in range, -1 exactly where the distance is inf
    assert not (ni == np.arange(n)[:, None]).any()
    assert ni.max() < n
    assert ((ni >= 0) == np.isfinite(nd)).all()
    f = np.where(np.isfinite(nd), nd, np.inf)
    assert (np.diff(f, axis=1) >= -1e-4).all()
    for r in range(0, n, 997):
        live = ni[r][ni[r] >= 0]
        assert len(set(live.tolist())) == len(live)


def test_refined_lists_subsume_seed_quality(iid_case):
    """Merging never loses a neighbour the seed already had: per row the
    worst kept distance does not grow."""
    xv, cd, ci = iid_case
    nd, _ = nn_descent_refine(xv, cd, ci, "l2sq", chunk=1024, max_rounds=1,
                              target_recall=0.99, seed=3)
    nd, cd0 = nd.numpy(), cd.numpy()
    worst_new = np.where(np.isfinite(nd), nd, -np.inf).max(axis=1)
    worst_old = np.where(np.isfinite(cd0), cd0, -np.inf).max(axis=1)
    assert (worst_new <= worst_old + 1e-3).all()


def test_adaptive_trigger_skips_good_lists():
    """Lists already above the target come back as the same tensors."""
    rng = np.random.default_rng(2)
    n, d, C = 5000, 16, 12
    xv = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    cd, ci = exact_knn(xv, torch.arange(n, dtype=torch.int32), C, "l2sq")
    nd, ni = nn_descent_refine(xv, cd, ci, "l2sq", chunk=1024, max_rounds=6,
                               target_recall=0.9, seed=3)
    assert nd is cd and ni is ci


def test_tiny_input_passthrough():
    rng = np.random.default_rng(4)
    xv = torch.from_numpy(rng.standard_normal((100, 8)).astype(np.float32))
    cd = torch.zeros((100, 4))
    ci = torch.zeros((100, 4), dtype=torch.int32)
    nd, ni = nn_descent_refine(xv, cd, ci, "l2sq", chunk=1024)
    assert nd is cd and ni is ci


def test_sampled_recall_equals_jax():
    """The same numpy sample, the same oracle and the same recall; real-
    valued data, so that no tie can order the oracles differently."""
    rng = np.random.default_rng(6)
    n, d, C = 3072, 16, 16
    xv = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    _, ci = _random_seed_lists(xv, C, rng)
    got = sampled_list_recall(xv, ci, "l2sq", n_sample=256, seed=7)
    want = j_recall(jnp.asarray(xv.numpy()), jnp.asarray(ci.numpy()), "l2sq", n_sample=256,
                    seed=7)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_nn_descent_equals_jax():
    rng = np.random.default_rng(5)
    n, d, C = 3072, 16, 16
    xv = torch.from_numpy(rng.integers(-8, 9, (n, d)).astype(np.float32))
    cd, ci = _random_seed_lists(xv, C, rng)
    td, ti = nn_descent_refine(xv, cd, ci, "l2sq", chunk=1024, max_rounds=3, seed=3)
    jd, ji = j_nnd(jnp.asarray(xv.numpy()), jnp.asarray(cd.numpy()), jnp.asarray(ci.numpy()),
                   "l2sq", chunk=1024, max_rounds=3, seed=3)
    assert not torch.equal(ti, ci)  # rounds ran
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
