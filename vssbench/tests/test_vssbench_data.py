"""The corpus generators: seeded, separable by stream, and the
distribution parameters of bench.py's SIFT-like and GIST-like formulas."""
import pytest
import torch

from vssbench.data import Corpus, subseed

SIFT = {"generator": "sift_like", "rows": 20000, "dims": 128, "centres": 64,
        "noise_sd": 25.0, "low": 0.0, "high": 255.0, "chunk_rows": 1000}
GIST = {"generator": "gist_like", "rows": 20000, "dims": 96, "centres": 64,
        "noise_sd": 0.12, "chunk_rows": 1000}


@pytest.mark.parametrize("spec", [SIFT, GIST], ids=["sift", "gist"])
def test_a_seed_repeats_and_another_differs(spec):
    a, b, c = Corpus(spec, 7, "cpu"), Corpus(spec, 7, "cpu"), Corpus(spec, 8, "cpu")
    assert torch.equal(a.base(), b.base())
    assert torch.equal(a.queries(50), b.queries(50))
    assert torch.equal(a.chunk(3), b.chunk(3))
    assert not torch.equal(a.base(), c.base())
    # each stream alone: the queries are not the first rows of the base
    assert not torch.equal(a.queries(50), a.base()[:50])


def test_large_seeds_give_63_bit_streams():
    s = subseed(2**31 + 9, "base")
    assert 0 <= s < 2**63 and s != subseed(2**31 + 10, "base")
    Corpus(SIFT, 2**33 + 1, "cpu").queries(4)


def test_sift_like_matches_bench_formula():
    c = Corpus(SIFT, 1, "cpu")
    x = c.base()
    assert x.shape == (20000, 128) and x.dtype == torch.float32
    assert float(x.min()) >= 0.0 and float(x.max()) <= 255.0
    cen = c.centres
    assert float(cen.min()) >= 0.0 and float(cen.max()) <= 255.0
    # every row is a centre plus N(0, 25^2), clipped: the nearest centre
    # explains it with a per-coordinate spread of about 25
    d = torch.cdist(x[:2000], cen)
    near = cen[d.argmin(1)]
    resid = (x[:2000] - near)
    inside = (x[:2000] > 1) & (x[:2000] < 254)
    sd = float(resid[inside].std())
    assert 22.0 < sd < 26.0
    assert abs(float(resid[inside].mean())) < 1.0


def test_gist_like_matches_bench_formula():
    c = Corpus(GIST, 1, "cpu")
    x = c.base()
    assert float(x.min()) >= 0.0
    cen = c.centres
    assert float(cen.min()) >= 0.0 and float(cen.max()) < 1.0
    d = torch.cdist(x[:2000], cen)
    near = cen[d.argmin(1)]
    # |c + 0.12 n|: where the centre is far from 0 the sign never flips
    far = near > 0.5
    sd = float((x[:2000] - near)[far].std())
    assert 0.11 < sd < 0.13


def test_rows_of_reads_base_and_chunks():
    c = Corpus(SIFT, 3, "cpu")
    base = c.base()
    ids = torch.tensor([0, 19999, 20000, 20999, 21000, 23456])
    rows = c.rows_of(ids, base, {})
    assert torch.equal(rows[0], base[0]) and torch.equal(rows[1], base[19999])
    assert torch.equal(rows[2], c.chunk(0)[0]) and torch.equal(rows[3], c.chunk(0)[999])
    assert torch.equal(rows[4], c.chunk(1)[0]) and torch.equal(rows[5], c.chunk(3)[456])
