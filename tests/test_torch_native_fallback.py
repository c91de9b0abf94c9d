"""`HNSWIndex.build(method="auto")` where the C++ builder cannot be built.

At 8,192 rows or fewer `auto` takes the native builder on one thread, but
only where it builds and loads (`native_available`); elsewhere it takes
the bulk builder, `exact`, as `vss_tpu/index/dense.py` does. Here the
library load is made to raise `NativeUnavailable` (as it does on a host
with no g++): `auto` must then equal `method="exact"` array for array,
and agree with `vss_tpu`'s `auto` under the same condition.
"""
import numpy as np
import pytest
import torch

import vss_tpu.csrc as jcsrc
import vss_tpu.index.dense as jdense
import vss_tpu.index.native as jnative
import vss_tpu_torch.index.native as tnative
from vss_tpu.index.graph import HNSWConfig as JConfig
from vss_tpu_torch import HNSWIndex, csrc
from vss_tpu_torch.convert import GRAPH_FIELDS
from vss_tpu_torch.index.graph import HNSWConfig as TConfig

N, D = 500, 16


@pytest.fixture
def no_native(monkeypatch):
    """Both packages' loads of the C++ builder raise NativeUnavailable;
    every other library loads as before."""
    load = csrc.load

    def refuse(name):
        if name == "hnsw_builder":
            raise csrc.NativeUnavailable("no compiler for hnsw_builder")
        return load(name)

    def jrefuse(name):
        raise jcsrc.NativeUnavailable("no compiler for hnsw_builder")

    monkeypatch.setattr(csrc, "load", refuse)
    monkeypatch.setattr(jnative, "load", jrefuse)


def _vecs():
    return np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)


def test_native_available_is_false_without_the_library(no_native):
    assert tnative.native_available() is False
    assert jnative.native_available() is False
    with pytest.raises(csrc.NativeUnavailable):
        tnative.build_graph_native(_vecs(), TConfig(dims=D), device="cpu")


def test_native_available_where_the_builder_loads(monkeypatch):
    monkeypatch.setattr(csrc, "load", lambda name: object())
    monkeypatch.setattr(tnative, "_lib", lambda: None)
    assert tnative.native_available() is True
    assert "native_available" in tnative.__all__


def test_auto_without_the_native_builder_is_exact(no_native):
    vecs = _vecs()
    auto = HNSWIndex.build(vecs, TConfig(dims=D, metric="l2sq"), method="auto", device="cpu")
    exact = HNSWIndex.build(vecs, TConfig(dims=D, metric="l2sq"), method="exact",
                            device="cpu")
    assert auto.build_stats["mode"] == "exact"
    assert auto.capacity == exact.capacity == 508
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(auto.graph, f).numpy(),
                                      getattr(exact.graph, f).numpy(), err_msg=f)
    assert auto.rowid_to_slot == exact.rowid_to_slot and auto.upper_used == exact.upper_used
    d1, r1 = auto.search(vecs[:32], 10, ef=32)
    d2, r2 = exact.search(vecs[:32], 10, ef=32)
    assert torch.equal(r1, r2) and torch.equal(d1, d2)


def test_auto_without_the_native_builder_agrees_with_vss_tpu(no_native):
    vecs = _vecs()
    tidx = HNSWIndex.build(vecs, TConfig(dims=D, metric="l2sq"), method="auto", device="cpu")
    jidx = jdense.HNSWIndex.build(vecs, JConfig(dims=D, metric="l2sq"), method="auto")
    assert tidx.capacity == jidx.capacity == 508
    assert tidx.count == jidx.count == N
    assert tidx.rowid_to_slot == jidx.rowid_to_slot
    _, tr = tidx.search(vecs[:32], 10, ef=32)
    _, jr = jidx.search(vecs[:32], 10, ef=32)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
