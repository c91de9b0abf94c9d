"""vss_tpu_torch/utils/datasets.py: the cases of `tests/test_datasets.py`
on the port. TexMex .fvecs/.bvecs/.ivecs files are written byte for byte
in the wire format by the tests and read back; no dataset ships with the
repository. The last case feeds a file through the port's index on the
CPU, and every case also holds the port's reader equal to the JAX
package's on the same file."""
import struct

import numpy as np
import pytest

import vss_tpu.utils.datasets as jds
from vss_tpu_torch.utils.datasets import (
    read_bvecs,
    read_fvecs,
    read_ivecs,
    read_vecs,
)


def _write_vecs(path, arr, fmt):
    with open(path, "wb") as f:
        for row in arr:
            f.write(struct.pack("<i", len(row)))
            for v in row:
                f.write(struct.pack(fmt, v))


def test_fvecs_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((17, 9)).astype(np.float32)
    p = str(tmp_path / "base.fvecs")
    _write_vecs(p, a, "<f")
    back = read_fvecs(p)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, a)
    np.testing.assert_array_equal(read_vecs(p), a)
    np.testing.assert_array_equal(jds.read_fvecs(p), back)


def test_bvecs_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (11, 4), dtype=np.uint8)
    p = str(tmp_path / "base.bvecs")
    _write_vecs(p, a, "<B")
    back = read_bvecs(p)
    assert back.dtype == np.float32  # bytes surface as f32 vectors
    np.testing.assert_array_equal(back, a.astype(np.float32))
    np.testing.assert_array_equal(jds.read_bvecs(p), back)


def test_ivecs_keeps_int32(tmp_path):
    # ids above 2^24 corrupt under a float32 cast (ADVICE r3) — the
    # ground-truth reader must stay integral
    a = np.asarray([[1, 2, 3], [(1 << 24) + 1, 5, 6]], np.int32)
    p = str(tmp_path / "gnd.ivecs")
    _write_vecs(p, a, "<i")
    back = read_ivecs(p)
    assert back.dtype == np.int32
    np.testing.assert_array_equal(back, a)
    np.testing.assert_array_equal(read_vecs(p), a)
    np.testing.assert_array_equal(jds.read_ivecs(p), back)


def test_vecs_error_paths(tmp_path):
    p = str(tmp_path / "bad.fvecs")
    with open(p, "wb") as f:
        f.write(b"\x01")  # truncated header
    with pytest.raises(ValueError, match="truncated"):
        read_fvecs(p)
    # ragged rows: header says 3 but second row claims 2
    p2 = str(tmp_path / "ragged.fvecs")
    with open(p2, "wb") as f:
        f.write(struct.pack("<i", 3) + struct.pack("<3f", 1, 2, 3))
        f.write(struct.pack("<i", 2) + struct.pack("<3f", 4, 5, 6))
    with pytest.raises(ValueError, match="ragged"):
        read_fvecs(p2)
    with pytest.raises(ValueError, match="unknown vector file format"):
        read_vecs(str(tmp_path / "x.weird"))


def test_vecs_files_feed_the_index(tmp_path):
    """The bench's dataset hook: a real corpus file round-trips into the
    same arrays the synthesizer would produce."""
    rng = np.random.default_rng(2)
    base = rng.uniform(0, 255, (64, 8)).astype(np.float32)
    p = str(tmp_path / "sift_base.fvecs")
    _write_vecs(p, base, "<f")
    loaded = read_vecs(p)
    assert loaded.shape == (64, 8) and loaded.dtype == np.float32
    np.testing.assert_array_equal(jds.read_vecs(p), loaded)
    # and they index/search fine end to end
    from vss_tpu_torch import HNSWConfig, HNSWIndex

    idx = HNSWIndex.build(loaded, HNSWConfig(dims=8), device="cpu")
    _, rows = idx.search(loaded[:4], k=1)
    assert rows[:, 0].tolist() == [0, 1, 2, 3]
