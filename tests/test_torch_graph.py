"""vss_tpu_torch.index.graph and utils against vss_tpu's on the CPU.

These are exact: configs, level samples, tape casts and padded shapes
must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vss_tpu.index.graph as jgraph
import vss_tpu.utils as jutils
import vss_tpu_torch.index.graph as tgraph
import vss_tpu_torch.utils as tutils
from vss_tpu_torch.convert import GRAPH_FIELDS


@pytest.mark.parametrize("kw", [
    {}, {"m": 8}, {"m": 12, "m0": 40}, {"storage_dtype": "int8"},
    {"storage_dtype": "bf16", "rerank": "f32"}, {"storage_dtype": "int8", "rerank": "none"},
])
def test_config_matches_jax(kw):
    j = jgraph.HNSWConfig(dims=16, **kw)
    t = tgraph.HNSWConfig(dims=16, **kw)
    assert (t.m, t.m0, t.ef_construction, t.ef_search, t.max_levels, t.inv_log_m) == (
        j.m, j.m0, j.ef_construction, j.ef_search, j.max_levels, j.inv_log_m)
    names = {None: None, torch.float32: "float32", torch.bfloat16: "bfloat16"}
    jr = j.rerank_dtype
    assert names[t.rerank_dtype] == (None if jr is None else jnp.dtype(jr).name)
    assert jnp.dtype(j.vector_dtype).name == str(t.vector_dtype).split(".")[-1]


@pytest.mark.parametrize("kw", [{"storage_dtype": "f16"}, {"rerank": "int8"}])
def test_config_errors_match_jax(kw):
    with pytest.raises(ValueError) as jex:
        jgraph.HNSWConfig(dims=4, **kw)
    with pytest.raises(ValueError) as tex:
        tgraph.HNSWConfig(dims=4, **kw)
    assert str(tex.value) == str(jex.value)


def test_sample_levels_same_seed_same_levels():
    for m in (4, 16):
        np.testing.assert_array_equal(
            tgraph.sample_levels(5000, tgraph.HNSWConfig(dims=4, m=m), seed=3),
            jgraph.sample_levels(5000, jgraph.HNSWConfig(dims=4, m=m), seed=3))


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_cast_to_tape_matches_jax(storage):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 8)) * 90).astype(np.float32)
    x[0, :4] = [0.5, 1.5, -2.5, 300.0]  # ties round to even; clip at +-127
    j = np.asarray(jgraph.cast_to_tape(jnp.asarray(x), jgraph.HNSWConfig(dims=8, storage_dtype=storage)))
    t = tgraph.cast_to_tape(torch.from_numpy(x), tgraph.HNSWConfig(dims=8, storage_dtype=storage))
    np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))


def test_empty_and_grown_graph_match_jax():
    jc, tc = jgraph.HNSWConfig(dims=8, m=6), tgraph.HNSWConfig(dims=8, m=6)
    jg, tg = jgraph.empty_graph(jc, 100), tgraph.empty_graph(tc, 100, device="cpu")
    jg2, tg2 = jgraph.grow_graph(jg, jc, 300), tgraph.grow_graph(tg, tc, 300)
    for a, b in ((jg, tg), (jg2, tg2)):
        for f in GRAPH_FIELDS:
            np.testing.assert_array_equal(
                getattr(b, f).float().numpy(), np.asarray(getattr(a, f)).astype(np.float32),
                err_msg=f)
    with pytest.raises(ValueError, match="shrink"):
        tgraph.grow_graph(tg2, tc, 50)
    assert tg2.to("cpu").capacity == 300


def test_check_rowids_int32():
    tgraph.check_rowids_int32(np.array([0, 2**31 - 1]))
    for bad in ([-1], [2**31]):
        with pytest.raises(ValueError) as tex:
            tgraph.check_rowids_int32(np.array(bad))
        with pytest.raises(ValueError) as jex:
            jgraph.check_rowids_int32(np.array(bad))
        assert str(tex.value) == str(jex.value)


@pytest.mark.parametrize("n,m", [(0, 8), (7, 8), (8, 8), (129, 128)])
def test_shape_helpers_match_jax(n, m):
    assert tutils.round_up(n, m) == jutils.round_up(n, m)
    assert tutils.cdiv(n, m) == jutils.cdiv(n, m)
    assert tutils.next_pow2(n) == jutils.next_pow2(n)
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    np.testing.assert_array_equal(
        tutils.pad_to(torch.from_numpy(x), 0, m, value=-1).numpy(),
        np.asarray(jutils.pad_to(jnp.asarray(x), 0, m, value=-1)))


def test_resolve_device():
    assert tutils.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tutils.resolve_device(None)
