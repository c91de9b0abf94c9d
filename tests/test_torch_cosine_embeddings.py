"""The cosine graph path at text-embedding widths, on the CPU: an
`HNSWIndex` (int8 tape, f32 rerank) built by `HNSWIndex.build` over unit-
norm rows around a common direction (the benchmark's `openai_like`
generator, a stand-in of OpenAI ada-002 embeddings) and searched with
`HNSWIndex.search`, held against the benchmark's plain reference
(`vssbench.reference`: exact k nearest in float32 with TF32 off, and the
direct form of each distance in float64), at d = 1,536 and at a small d.
"""
import numpy as np
import pytest
import torch

from vss_tpu_torch import HNSWConfig, HNSWIndex
from vssbench import reference
from vssbench.data import Corpus

# the stand-in's constants, at a few thousand rows: 30 topics of about 100
# rows, so that a query's 10 nearest lie in its own topic
SPEC = {"generator": "openai_like", "rows": 3000, "centres": 30, "mean_share": 0.7,
        "centre_share": 0.15, "noise_share": 0.15, "chunk_rows": 1000}
K, EF = 10, 64
# recall@10 at ef 64: the search is approximate (the int8 tape ranks the
# beam's candidates; the f32 rerank orders only what the beam kept), so it
# is held to the share the benchmark's graph cells reach at full size
# (about 0.9), not to 1
RECALL = 0.9
# a reported distance against the direct float64 cosine distance of its
# query and row: the f32 rerank's dot of d products (rounding of order
# sqrt(d) 2^-24 of the dot) over distances near 0.15; the benchmark's
# dist_err limit, which the TF32 control breaks
DIST_ERR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("d", [1536, 48])
def test_cosine_graph_search_against_the_plain_reference(d):
    corpus = Corpus(dict(SPEC, dims=d), 2**31 + 5, "cpu")
    rows, q = corpus.base(), corpus.queries(48)
    cfg = HNSWConfig(dims=d, metric="cosine", storage_dtype="int8", rerank="f32")
    idx = HNSWIndex.build(rows, cfg, device="cpu")
    dist, ids = idx.search(q, K, ef=EF)
    ids = ids.to(torch.int64)
    # every answer: live ids, each at most once, distances ascending
    assert bool((ids >= 0).all()) and bool((ids < rows.shape[0]).all())
    s = torch.sort(ids, 1).values
    assert not bool((s[:, 1:] == s[:, :-1]).any())
    assert bool((dist[:, 1:] >= dist[:, :-1]).all())
    _, exact = reference.knn(q, rows, K, metric="cosine")
    assert float(reference.recall(ids, exact).mean()) >= RECALL
    direct = reference.distances(q, rows[ids], "cosine")
    rel = ((dist.double() - direct).abs() / direct.abs().clamp_min(1e-3)).max()
    assert float(rel) <= DIST_ERR
