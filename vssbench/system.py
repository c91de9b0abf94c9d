"""The system under test: `vss_tpu_torch.HNSWIndex`, behind the four
calls the traffic makes. The only module of the benchmark that imports
the port.

Each call takes host float32 (the client's queries or rows) and returns
when its result is on the host: a read returns host (distances, row ids);
a write returns once the device has finished its work, so the next
request's time does not carry it.
"""
from __future__ import annotations

import numpy as np
import torch


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PortSystem:
    """An `HNSWIndex` built by `HNSWIndex.build` over the base rows."""

    def __init__(self, index_spec: dict, dims: int, device):
        from vss_tpu_torch import HNSWConfig

        self.device = torch.device(device)
        self.config = HNSWConfig(
            dims=dims, metric=index_spec["metric"], m=index_spec["m"], m0=index_spec["m0"],
            ef_construction=index_spec["ef_construction"],
            ef_search=index_spec["ef_search"],
            storage_dtype=index_spec["storage_dtype"], rerank=index_spec["rerank"],
        )
        self.method = index_spec["build"]
        self.index = None

    def prepare(self) -> float:
        """Builds the port's CUDA libraries where they are missing or stale
        (into its fixed build directory); the seconds it took."""
        if self.device.type != "cuda":
            return 0.0
        from vss_tpu_torch import csrc

        return csrc.build([n for n, s in csrc.SOURCES.items()
                           if s.endswith(".cu") and n != "probe"])

    def build(self, rows: torch.Tensor):
        from vss_tpu_torch import HNSWIndex

        self.index = HNSWIndex.build(rows, self.config, method=self.method,
                                     device=self.device)
        sync(self.device)

    def stats(self) -> dict:
        return dict(self.index.build_stats)

    def search(self, q: np.ndarray, k: int, ef):
        d, ids = self.index.search(q, k, ef=ef)
        return d.cpu().numpy(), ids.cpu().numpy()

    def scan_search(self, q: np.ndarray, k: int):
        d, ids = self.index.scan_search(q, k)
        return d.cpu().numpy(), ids.cpu().numpy()

    def insert(self, rows: np.ndarray, ids: np.ndarray):
        self.index.insert(rows, ids)
        sync(self.device)

    def delete(self, ids: np.ndarray):
        self.index.delete(ids)
        sync(self.device)

    def close(self):
        self.index = None
