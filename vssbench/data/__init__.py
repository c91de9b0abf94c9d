"""Corpus generators, one module per generator, found by the name a
configuration's `corpus.generator` gives.

A generator module defines `centres(spec, gen)` and `draw(spec, centres,
n, gen)`; both make float32 rows on the generator's device. `Corpus`
composes them: every stream of rows (the centres, the base rows, the
query pool, each chunk of inserted rows) has a generator of its own,
seeded from the run's seed and the stream's name, so that any of them can
be made again alone and comes out the same.
"""
from __future__ import annotations

import hashlib
import importlib

import torch

# rows a generator call makes at once, so that the temporaries of a wide
# corpus stay a few hundred MB
_BLOCK_ROWS = 131_072


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by `tags` under the run's seed."""
    digest = hashlib.sha256(repr((int(seed),) + tuple(tags)).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, device, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, *tags))
    return g


def module(name: str):
    if not name.replace("_", "").isalnum():
        raise ValueError(f"bad generator name {name!r}")
    return importlib.import_module(f"vssbench.data.{name}")


class Corpus:
    """The rows of one configuration under one seed, made on `device`.

    Row ids: 0 .. rows-1 are the base corpus; the inserted rows follow
    from id `rows` on, in chunks of `chunk_rows`, chunk c holding ids
    rows + c * chunk_rows onward."""

    def __init__(self, spec: dict, seed: int, device):
        self.spec = spec
        self.seed = int(seed)
        self.device = torch.device(device)
        self.gen = module(spec["generator"])
        self.rows = int(spec["rows"])
        self.dims = int(spec["dims"])
        self.chunk_rows = int(spec.get("chunk_rows", 262_144))
        self.centres = self.gen.centres(spec, generator(self.seed, self.device, "centres"))

    def _draw(self, n: int, *tags) -> torch.Tensor:
        g = generator(self.seed, self.device, *tags)
        out = torch.empty((n, self.dims), dtype=torch.float32, device=self.device)
        for s in range(0, n, _BLOCK_ROWS):
            out[s:s + _BLOCK_ROWS] = self.gen.draw(
                self.spec, self.centres, min(_BLOCK_ROWS, n - s), g)
        return out

    def base(self) -> torch.Tensor:
        """The base corpus [rows, dims]."""
        return self._draw(self.rows, "base")

    def queries(self, n: int) -> torch.Tensor:
        """The query pool [n, dims], drawn like the rows."""
        return self._draw(n, "queries")

    def chunk(self, c: int) -> torch.Tensor:
        """Inserted-row chunk c [chunk_rows, dims]."""
        return self._draw(self.chunk_rows, "stream", int(c))

    def rows_of(self, ids, base: torch.Tensor, chunks: dict) -> torch.Tensor:
        """Rows of `ids` (a 1-D int64 tensor on the device), from `base`
        and from the chunks in `chunks` (made here where missing)."""
        ids = ids.to(self.device, torch.int64)
        out = torch.empty((ids.numel(), self.dims), dtype=torch.float32, device=self.device)
        in_base = ids < self.rows
        out[in_base] = base[ids[in_base]]
        sid = ids[~in_base] - self.rows
        if sid.numel():
            cidx = sid // self.chunk_rows
            rest = out[~in_base]
            for c in torch.unique(cidx).tolist():
                if c not in chunks:
                    chunks[c] = self.chunk(c)
                sel = cidx == c
                rest[sel] = chunks[c][sid[sel] - c * self.chunk_rows]
            out[~in_base] = rest
        return out
