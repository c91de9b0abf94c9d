"""vss_tpu_torch.index.select against vss_tpu.index.select on the CPU.

The same candidate lists go through `select_neighbors` of both packages.
On tie-free seeded data the chosen ids must be equal; `pairwise_rowwise`
must agree within rtol 1e-5, atol 1e-5 (f32 sums in another order). One
case makes equal distances among the pruned candidates and pins the
order of the fill: ascending by distance, ties to the lower position of
the sorted list.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vss_tpu.index.select as jselect
import vss_tpu_torch.index.select as tselect
from vss_tpu.ops.distance import gathered_distances as jax_gathered_distances

RTOL, ATOL = 1e-5, 1e-5
A, C, D, N, M = 24, 20, 16, 300, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers at once, each with JAX's own thread
    pool: PyTorch's intra-op threads then contend for the same cores and
    the small eager ops of a wave get many times slower. One thread per
    worker is the faster setting there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(metric, seed=0, c=C):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((A, D)).astype(np.float32)
    cand_i = np.stack([rng.choice(N, c, replace=False) for _ in range(A)]).astype(np.int32)
    cand_i[0, -3:] = -1  # short lists
    cand_i[1, :] = -1  # an empty list
    cand_d = np.asarray(jax_gathered_distances(
        jnp.asarray(q), jnp.asarray(table[np.maximum(cand_i, 0)]), metric))
    cand_d = np.where(cand_i >= 0, cand_d, np.inf).astype(np.float32)
    return table, q, cand_i, cand_d


def _both(table, q, cand_i, cand_d, m, metric, active=None, with_vecs=False):
    jkw, tkw = {}, {}
    if active is not None:
        jkw["active"], tkw["active"] = jnp.asarray(active), torch.from_numpy(active)
    if with_vecs:
        cv = table[np.maximum(cand_i, 0)]
        jkw["cand_vecs"], tkw["cand_vecs"] = jnp.asarray(cv), torch.from_numpy(cv)
    want = np.asarray(jselect.select_neighbors(
        jnp.asarray(q), jnp.asarray(cand_i), jnp.asarray(cand_d), jnp.asarray(table),
        m, metric, **jkw))
    got = tselect.select_neighbors(
        torch.from_numpy(q), torch.from_numpy(cand_i), torch.from_numpy(cand_d),
        torch.from_numpy(table), m, metric, **tkw).numpy()
    return want, got


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_pairwise_rowwise_matches_jax(metric):
    rng = np.random.default_rng(1)
    vecs = rng.standard_normal((6, 9, D)).astype(np.float32)
    vecs[0, 0] = 0  # the cosine zero-vector guard
    want = np.asarray(jselect.pairwise_rowwise(jnp.asarray(vecs), metric))
    got = tselect.pairwise_rowwise(torch.from_numpy(vecs), metric).numpy()
    assert got.shape == (6, 9, 9)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_select_neighbors_matches_jax(metric):
    table, q, cand_i, cand_d = _case(metric)
    want, got = _both(table, q, cand_i, cand_d, M, metric)
    assert got.shape == (A, M) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[1] == -1).all()
    # pre-deduplicated in, no duplicate out
    for row in got:
        kept = row[row >= 0]
        assert len(set(kept.tolist())) == kept.size


def test_select_neighbors_fewer_candidates_than_m():
    table, q, cand_i, cand_d = _case("l2sq", seed=2, c=5)
    want, got = _both(table, q, cand_i, cand_d, M, "l2sq")
    np.testing.assert_array_equal(got, want)
    assert got.shape == (A, M) and (got[:, 5:] == -1).all()


def test_select_neighbors_inactive_rows_and_given_vectors():
    table, q, cand_i, cand_d = _case("l2sq", seed=3)
    active = np.arange(A) % 3 != 0
    want, got = _both(table, q, cand_i, cand_d, M, "l2sq", active=active, with_vecs=True)
    np.testing.assert_array_equal(got, want)
    assert (got[~active] == -1).all() and (got[active][:, 0] >= 0).any()
    plain, _ = _both(table, q, cand_i, cand_d, M, "l2sq", active=active)
    np.testing.assert_array_equal(got, plain)


def test_fill_order_on_equal_pruned_distances():
    """Candidates 1..4 lie at one point, equally far from q: the first is
    kept (after the nearer candidate 0 fails to shadow it), the other
    three are pruned by it at equal distance, and the fill takes them in
    list order."""
    table = np.zeros((8, D), np.float32)
    table[0, 0] = 1.0  # nearest, kept
    table[1:5, 1] = 2.0  # four copies of one point
    table[5, 0] = -3.0  # farther, on the far side: kept
    q = np.zeros((1, D), np.float32)
    cand_i = np.array([[3, 5, 1, 0, 4, 2]], np.int32)
    cand_d = ((table[cand_i[0]] - q) ** 2).sum(-1)[None].astype(np.float32)
    want, got = _both(table, q, cand_i, cand_d, 6, "l2sq")
    np.testing.assert_array_equal(got, want)
    # kept: 0 (d=1), 3 (d=4, first of the tied group in list order), 5
    # (d=9); fill: the pruned 1, 4, 2 in the order of the sorted list
    assert got[0].tolist() == [0, 3, 5, 1, 4, 2]
