"""vss_tpu_torch: the PyTorch/CUDA port of vss_tpu for an NVIDIA H100.

A second package beside `vss_tpu` (the JAX reference, which it never
imports); this file reproduces `vss_tpu/__init__.py` for the ported
modules: `HNSWIndex` (serving, writes, builds), storage (checkpoints,
the WAL, the block store), the query layer with its SQL front end and
the sharded index (`vss_tpu_torch.parallel`). Plain
tensor code is PyTorch; every TPU kernel on the ported
path is a hand-written CUDA kernel for sm_90a under `csrc/`, built with
nvcc at first use, with a plain PyTorch version beside it for CPU
tensors. Entry points run on the CUDA device unless `device="cpu"` is
passed.

    import numpy as np
    from vss_tpu_torch import Database, HNSWConfig, HNSWIndex

    db = Database()                       # on the GPU; Database(device="cpu")
    db.create_table("items", {"id": np.arange(n), "vec": vectors})
    db.sql("CREATE INDEX idx ON items USING HNSW (vec) WITH (metric='l2sq')")
    db.sql("SELECT id FROM items ORDER BY array_distance(vec, [...]::FLOAT[128]) LIMIT 10")

    idx = HNSWIndex.build(vectors, HNSWConfig(dims=128, storage_dtype="int8"),
                          method="native")
    dists, rowids = idx.search(queries, k=10, ef=64)
    dists, rowids = idx.scan_search(queries, k=10)
    idx.insert(new_vectors, new_rowids)
    idx.delete(old_rowids)
    idx.compact()
"""
import torch

# The exact paths need true f32 products: TF32 keeps about three decimal
# digits, and the l2sq form |q|^2+|x|^2-2qx cancels catastrophically.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from vss_tpu_torch.index import HNSWConfig, HNSWIndex  # noqa: E402
from vss_tpu_torch.ops import Metric  # noqa: E402
from vss_tpu_torch.query import (  # noqa: E402
    BinderError,
    Database,
    Query,
    Table,
    col,
    const,
    fn,
    vss_join,
    vss_match,
)

__version__ = "0.1.0"

__all__ = [
    "Database",
    "Table",
    "Query",
    "HNSWIndex",
    "HNSWConfig",
    "Metric",
    "BinderError",
    "col",
    "const",
    "fn",
    "vss_join",
    "vss_match",
]
