"""The plain reference: exact k nearest against a naive loop, TF32 off,
the TF32 control's rounding, the direct distances and recall."""
import numpy as np
import pytest
import torch

from vssbench import reference


def naive_knn(q, x, k, metric):
    out_d, out_i = [], []
    for qi in q.double():
        if metric == "cosine":
            d = [1.0 - float(qi @ xi / (qi.norm() * xi.norm())) for xi in x.double()]
        else:
            d = [float(((qi - xi) ** 2).sum()) for xi in x.double()]
        order = sorted(range(len(d)), key=lambda j: (d[j], j))[:k]
        out_d.append([d[j] for j in order])
        out_i.append(order)
    return np.array(out_d), np.array(out_i)


@pytest.mark.parametrize("metric", ["l2sq", "cosine"])
@pytest.mark.parametrize("n,block", [(300, 64), (300, 262_144), (97, 10)])
def test_knn_equals_naive_loop(metric, n, block, monkeypatch):
    monkeypatch.setattr(reference, "_BLOCK", block)
    g = torch.Generator().manual_seed(n + block)
    x = torch.rand((n, 8), generator=g) * 10
    q = torch.rand((11, 8), generator=g) * 10
    d, i = reference.knn(q, x, 7, metric=metric)
    nd, ni = naive_knn(q, x, 7, metric)
    assert np.array_equal(i.numpy(), ni)
    np.testing.assert_allclose(d.numpy(), nd, rtol=1e-4, atol=1e-4)


def test_knn_with_ties_keeps_the_exact_distances(monkeypatch):
    monkeypatch.setattr(reference, "_BLOCK", 50)
    g = torch.Generator().manual_seed(1)
    x = torch.randint(0, 6, (300, 8), generator=g).float()
    q = torch.randint(0, 6, (11, 8), generator=g).float()
    d, i = reference.knn(q, x, 7)
    nd, _ = naive_knn(q, x, 7, "l2sq")
    assert np.array_equal(d.numpy(), nd)
    assert np.array_equal(reference.distances(q, x[i]).numpy(), nd)


def test_knn_names_rows_by_their_ids():
    x = torch.tensor([[0.0], [5.0], [1.0]])
    d, i = reference.knn(torch.tensor([[0.9]]), x, 2, ids=torch.tensor([40, 41, 42]))
    assert i.tolist() == [[42, 40]]


def test_tf32_is_off_while_the_reference_runs_and_restored(monkeypatch):
    seen = []
    real = torch.topk

    def spy(*a, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return real(*a, **kw)

    monkeypatch.setattr(torch, "topk", spy)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        reference.knn(torch.ones(2, 4), torch.rand(10, 4), 3)
        assert seen and all(s == (False, False) for s in seen)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_round_tf32_keeps_ten_mantissa_bits_to_nearest_even():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-11 + 2**-20, 3.0])
    r = reference.round_tf32(x)
    assert r.tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-9, 1.0 + 2**-10, 3.0]


def test_tf32_distances_are_off_by_far_more_than_f32():
    g = torch.Generator().manual_seed(0)
    x = torch.rand((2000, 128), generator=g) * 255
    q = torch.rand((20, 128), generator=g) * 255
    d32, i32 = reference.knn(q, x, 5)
    dtf, itf = reference.knn(q, x, 5, precision="tf32")
    exact32 = reference.distances(q, x[i32])
    exacttf = reference.distances(q, x[itf])
    err32 = float(((d32.double() - exact32).abs() / exact32).max())
    errtf = float(((dtf.double() - exacttf).abs() / exacttf).max())
    assert err32 < 1e-4 < errtf


def test_distances_direct_form():
    q = torch.tensor([[1.0, 2.0]])
    rows = torch.tensor([[[1.0, 2.0], [4.0, 6.0]]])
    assert reference.distances(q, rows).tolist() == [[0.0, 25.0]]
    c = reference.distances(q, rows, "cosine")
    assert abs(float(c[0, 0])) < 1e-12


def test_recall_arithmetic():
    exact = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
    found = torch.tensor([[4, 3, 9, -1], [5, 6, 7, 8]])
    assert reference.recall(found, exact).tolist() == [0.5, 1.0]
