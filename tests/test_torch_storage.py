"""Storage of vss_tpu_torch on the CPU: index checkpoints, the WAL, the
memory-mapped view and the block store.

Ports `tests/test_persistence.py` (all nine tests),
`tests/test_native.py::TestBlockStore` (five) and
`test_blockstore_rejects_long_names`,
`tests/test_rerank.py::test_rerank_tape_checkpoint_roundtrip` and the
persistence half of `tests/test_bf16.py::test_int8_crud_and_persistence`
to the port, with `device="cpu"` on every entry point. Where the JAX
tests held a round trip to equal results, these do too (ids equal,
distances within rtol 1e-6).
"""
import io
import os

import numpy as np
import pytest
import torch

from vss_tpu_torch import Database, HNSWConfig, HNSWIndex
from vss_tpu_torch.storage import (
    deserialize_index,
    load_index,
    save_index,
    serialize_index,
    view_index,
)
from vss_tpu_torch.storage.blockfile import BlockStore, blockstore_available

CPU = "cpu"


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _mapped_from(path, ptr) -> bool:
    """Whether address `ptr` lies in a memory map of the file `path`."""
    if not os.path.exists("/proc/self/maps"):
        pytest.skip("no /proc/self/maps")
    real = os.path.realpath(path)
    with open("/proc/self/maps") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 6 and parts[5] == real:
                lo, hi = (int(x, 16) for x in parts[0].split("-"))
                if lo <= ptr < hi:
                    return True
    return False


@pytest.fixture
def built(rng):
    vecs = rng.standard_normal((400, 12)).astype(np.float32)
    cfg = HNSWConfig(dims=12, metric="cosine", m=8, ef_construction=64)
    idx = HNSWIndex.build(vecs, cfg, wave_size=128, device=CPU)
    return idx, vecs


def test_roundtrip_search_identical(built, rng, tmp_path):
    idx, vecs = built
    p = str(tmp_path / "index.vss")
    save_index(idx, p)
    assert not idx.dirty
    idx2 = load_index(p, device=CPU)
    assert idx2.count == idx.count
    assert idx2.config == idx.config
    q = rng.standard_normal((20, 12)).astype(np.float32)
    d1, r1 = idx.search(q, k=5)
    d2, r2 = idx2.search(q, k=5)
    np.testing.assert_array_equal(_np(r1), _np(r2))
    np.testing.assert_allclose(_np(d1), _np(d2), rtol=1e-6)


def test_roundtrip_preserves_tombstones(built, tmp_path):
    idx, vecs = built
    idx.delete([0, 1, 2])
    p = str(tmp_path / "index.vss")
    save_index(idx, p)
    idx2 = load_index(p, device=CPU)
    assert idx2.deleted_count == 3
    assert sorted(idx2.free_slots) == sorted(idx.free_slots)
    d, rows = idx2.search(vecs[0][None], k=3)
    assert 0 not in _np(rows)
    # recycled insert still works after reload
    idx2.insert(vecs[0][None], [9000])
    d, rows = idx2.search(vecs[0][None], k=1)
    assert int(rows[0, 0]) == 9000


def test_roundtrip_then_modify(built, rng, tmp_path):
    idx, vecs = built
    p = str(tmp_path / "index.vss")
    save_index(idx, p)
    idx2 = load_index(p, device=CPU)
    nv = rng.standard_normal((10, 12)).astype(np.float32)
    idx2.insert(nv, np.arange(1000, 1010))
    assert idx2.count == 410
    d, rows = idx2.search(nv[:3], k=1)
    assert _np(rows)[:, 0].tolist() == [1000, 1001, 1002]
    assert idx2.dirty


def test_bad_magic_rejected():
    with pytest.raises(ValueError, match="bad checkpoint magic"):
        deserialize_index(io.BytesIO(b"NOTVSS00" + b"\x00" * 64), device=CPU)


def test_truncated_rejected(built):
    idx, _ = built
    buf = io.BytesIO()
    serialize_index(idx, buf)
    data = buf.getvalue()
    with pytest.raises(ValueError, match="truncated"):
        deserialize_index(io.BytesIO(data[: len(data) // 2]), device=CPU)


def test_empty_index_roundtrip(tmp_path):
    cfg = HNSWConfig(dims=4)
    idx = HNSWIndex(cfg, device=CPU)
    p = str(tmp_path / "empty.vss")
    save_index(idx, p)
    idx2 = load_index(p, device=CPU)
    assert idx2.count == 0
    d, rows = idx2.search(np.zeros((1, 4), np.float32), k=3)
    assert np.all(_np(rows) == -1)


def test_load_needs_a_device_or_a_gpu(built, tmp_path):
    """Like every entry point of the port, loading runs on CUDA unless
    the caller asks for the CPU, and raises where there is no GPU."""
    idx, _ = built
    p = str(tmp_path / "index.vss")
    save_index(idx, p)
    if torch.cuda.is_available():
        assert load_index(p).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_index(p)


class TestWalAndView:
    """WAL replay + mmap view() load (the reference's WAL path and
    usearch view(), hnsw_index.cpp:574-585 / index.hpp:3276-3310 — except
    this WAL actually replays, unlike upstream's)."""

    def test_wal_replay_after_crash(self, tmp_path, rng):
        db = Database(device=CPU)
        db.sql("CREATE TABLE t (id BIGINT, vec FLOAT[4])")
        db.insert(
            "t",
            {"id": np.arange(100),
             "vec": rng.standard_normal((100, 4)).astype(np.float32)},
        )
        db.sql("SET hnsw_enable_experimental_persistence = TRUE")
        db.create_hnsw_index("idx", "t", "vec")
        path = str(tmp_path / "d")
        db.checkpoint(path)
        db.enable_wal()
        # post-checkpoint DML: logged, NOT re-checkpointed
        db.insert("t", {"id": [500], "vec": [[9.0, 9.0, 9.0, 9.0]]})
        db.delete("t", [0, 1])
        db.update("t", [2], {"vec": [[7.0, 7.0, 7.0, 7.0]]})
        want = db.sql("SELECT count(*) FROM t")["count"][0]
        # "crash": reopen from the stale checkpoint; WAL replays
        db2 = Database.open(path, device=CPU)
        assert db2.sql("SELECT count(*) FROM t")["count"][0] == want
        r = db2.sql(
            "SELECT id FROM t ORDER BY array_distance(vec, [9.,9.,9.,9.]) LIMIT 1"
        )
        assert r["id"][0] == 500  # index was maintained during replay
        r = db2.sql(
            "SELECT id FROM t ORDER BY array_distance(vec, [7.,7.,7.,7.]) LIMIT 1"
        )
        assert r["id"][0] == 2  # the updated row's new vector is indexed
        # checkpoint truncates the log; reopening applies nothing twice
        db2.checkpoint(path)
        db3 = Database.open(path, device=CPU)
        assert db3.sql("SELECT count(*) FROM t")["count"][0] == want

    def test_wal_torn_tail_ignored(self, tmp_path, rng):
        db = Database(device=CPU)
        db.sql("CREATE TABLE t (id BIGINT, s VARCHAR)")
        db.insert("t", {"id": [1], "s": ["a"]})
        path = str(tmp_path / "d")
        db.checkpoint(path)
        wal = db.enable_wal()
        db.insert("t", {"id": [2], "s": [None]})
        with open(wal, "a") as f:
            f.write('{"op": "insert", "table": "t", "da')  # torn record
        db2 = Database.open(path, device=CPU)
        assert db2.sql("SELECT count(*) FROM t")["count"][0] == 2
        assert db2.sql("SELECT s FROM t")["s"].tolist() == ["a", None]

    def test_view_index_mmap(self, built, tmp_path, rng):
        idx, vecs = built
        p = str(tmp_path / "index.vss")
        save_index(idx, p)
        v = load_index(p, view=True, device=CPU)
        # the tensors are the memory maps: nothing was copied at load
        assert v.graph.vectors.shape[0] == idx.next_slot
        assert _mapped_from(p, v.graph.vectors.data_ptr())
        q = vecs[:10] + 0.01
        d1, r1 = idx.search(q, k=5)
        d2, r2 = v.search(q, k=5)
        np.testing.assert_array_equal(_np(r1), _np(r2))
        # a view can still accept DML (copy-on-grow), and the file is
        # never written
        before = open(p, "rb").read()
        v.insert(rng.standard_normal((3, 12)).astype(np.float32), [900, 901, 902])
        d3, r3 = v.search(v.graph.vectors[v.rowid_to_slot[900]][None].float(), k=1)
        assert int(r3[0, 0]) == 900
        assert open(p, "rb").read() == before


def test_rerank_tape_checkpoint_roundtrip(tmp_path):
    """`tests/test_rerank.py::test_rerank_tape_checkpoint_roundtrip`."""
    d = 16
    rng = np.random.default_rng(5)
    centers = rng.uniform(0, 255, (32, d))
    x = np.clip(centers[rng.integers(0, 32, 300)] + rng.normal(0, 25, (300, d)),
                0, 255).astype(np.float32)
    idx = HNSWIndex.build(x, HNSWConfig(dims=d, storage_dtype="int8"), method="exact",
                          device=CPU)
    p = str(tmp_path / "idx.bin")
    save_index(idx, p)
    for view in (False, True):
        idx2 = load_index(p, view=view, device=CPU)
        assert idx2.rerank_tape is not None
        d1, r1 = idx.search(x[:16], k=5, ef=64)
        d2, r2 = idx2.search(x[:16], k=5, ef=64)
        np.testing.assert_array_equal(_np(r1), _np(r2))
        np.testing.assert_allclose(_np(d1), _np(d2), rtol=1e-6)


def test_int8_crud_and_persistence(rng, tmp_path):
    """The persistence half of `tests/test_bf16.py::
    test_int8_crud_and_persistence` (its CRUD half is in
    `test_torch_bf16.py`)."""
    vecs = rng.uniform(0, 255, (400, 16)).astype(np.float32)
    cfg = HNSWConfig(dims=16, storage_dtype="int8")
    idx = HNSWIndex.build(vecs, cfg, wave_size=128, method="wave", device=CPU)
    idx.delete([1, 2])
    idx.insert(rng.uniform(0, 255, (2, 16)).astype(np.float32), [900, 901])
    p = str(tmp_path / "int8.vss")
    save_index(idx, p)
    idx2 = load_index(p, device=CPU)
    assert idx2.vector_scale == idx.vector_scale
    sd1, r1 = idx.search(vecs[:10], k=3)
    sd2, r2 = idx2.search(vecs[:10], k=3)
    np.testing.assert_array_equal(_np(r1), _np(r2))


@pytest.mark.parametrize("rerank", ["none", "bf16"])
def test_bf16_arrays_roundtrip_without_ml_dtypes(rng, tmp_path, rerank):
    """bf16 tapes travel as 16-bit words under the dtype name "bfloat16",
    bit for bit, in a stream and in a view."""
    vecs = rng.standard_normal((300, 8)).astype(np.float32)
    cfg = HNSWConfig(dims=8, storage_dtype="bf16", rerank=rerank)
    idx = HNSWIndex.build(vecs, cfg, device=CPU)
    p = str(tmp_path / "bf16.vss")
    save_index(idx, p)
    for view in (False, True):
        idx2 = load_index(p, view=view, device=CPU)
        n = idx.next_slot
        assert idx2.graph.vectors.dtype == torch.bfloat16
        assert torch.equal(idx2.graph.vectors[:n].view(torch.int16),
                           idx.graph.vectors[:n].view(torch.int16))
        if rerank == "bf16":
            assert torch.equal(idx2.rerank_tape[:n].view(torch.int16),
                               idx.rerank_tape[:n].view(torch.int16))
        _, r1 = idx.search(vecs[:8], k=4)
        _, r2 = idx2.search(vecs[:8], k=4)
        np.testing.assert_array_equal(_np(r1), _np(r2))


def test_view_index_on_cuda_uploads_once(built, tmp_path):
    idx, _ = built
    p = str(tmp_path / "index.vss")
    save_index(idx, p)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            view_index(p)
        return
    v = view_index(p)
    assert v.graph.vectors.device.type == "cuda"


class TestBlockStore:
    """`tests/test_native.py::TestBlockStore`, over the port's copy of
    `blockstore.cpp` (built by g++ into `vss_tpu_torch/_build/`)."""

    @pytest.fixture(autouse=True)
    def _check(self):
        if not blockstore_available():
            pytest.skip("no C++ toolchain")

    def test_put_get_roundtrip(self, tmp_path):
        p = str(tmp_path / "store.vssdb")
        with BlockStore(p, block_size=4096) as bs:
            bs.put("a", b"hello world")
            bs.put("big", bytes(range(256)) * 100)  # multi-block
            assert bs.get("a") == b"hello world"
            assert bs.get("big") == bytes(range(256)) * 100
        # reopen
        with BlockStore(p) as bs:
            assert sorted(bs.list()) == ["a", "big"]
            assert bs.get("a") == b"hello world"
            assert bs.get("big") == bytes(range(256)) * 100

    def test_overwrite_and_delete(self, tmp_path):
        p = str(tmp_path / "store.vssdb")
        with BlockStore(p, block_size=4096) as bs:
            bs.put("x", b"v1")
            bs.put("x", b"v2" * 5000)
            assert bs.get("x") == b"v2" * 5000
            bs.delete("x")
            assert "x" not in bs
            with pytest.raises(KeyError):
                bs.get("x")

    def test_block_reclaim(self, tmp_path):
        """The reference's hnsw_reclaim_storage behavior: drop/recreate
        loops must reuse blocks, not grow the file."""
        p = str(tmp_path / "store.vssdb")
        payload = bytes(1000) * 500  # ~500KB -> many blocks
        with BlockStore(p, block_size=4096) as bs:
            bs.put("idx", payload)
            grown = bs.total_blocks
            for _ in range(5):
                bs.delete("idx")
                bs.put("idx", payload)
            # allow a little slack for directory chain movement
            assert bs.total_blocks <= grown + 4, (bs.total_blocks, grown)

    def test_missing_stream(self, tmp_path):
        with BlockStore(str(tmp_path / "s.vssdb")) as bs:
            with pytest.raises(KeyError):
                bs.get("nope")

    def test_empty_value(self, tmp_path):
        p = str(tmp_path / "s.vssdb")
        with BlockStore(p) as bs:
            bs.put("empty", b"")
            assert bs.get("empty") == b""
        with BlockStore(p) as bs:
            assert bs.get("empty") == b""


def test_blockstore_rejects_long_names(tmp_path):
    """Directory records have a fixed 56-byte name field; longer names
    previously truncated silently and could collide after reopen."""
    if not blockstore_available():
        pytest.skip("native blockstore unavailable")
    with BlockStore(str(tmp_path / "s.vssdb")) as bs:
        bs.put("x" * 55, b"ok")
        with pytest.raises(IOError):
            bs.put("y" * 56, b"no")
        assert bs.get("x" * 55) == b"ok"


def test_blockstore_builds_into_the_build_dir():
    from vss_tpu_torch import csrc

    if not blockstore_available():
        pytest.skip("native blockstore unavailable")
    assert os.path.exists(os.path.join(csrc.BUILD_DIR, "libblockstore.so"))
    assert not os.path.exists(os.path.join(os.path.dirname(csrc.__file__),
                                           "libblockstore.so"))
