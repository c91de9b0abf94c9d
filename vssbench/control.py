"""The readings that the check's limits are set from: the control (the
plain reference put in the program's place and computed one precision
below the configuration's: TF32 for its float32 with TF32 off), faults
planted in the program, and sound runs of the port. The control's and
the faults' runs have to come out as not correct.

    python3 vssbench/control.py --workload <cell> --seeds <n> [<n> ...] --seconds <s> \
        [--system control|port|ef-halved|block-skipped]

runs the cell's traffic through the chosen system, on the card, at the
cell's own sizes, once per seed in one process, and prints each run's
compared numbers. The benchmark's own runs never run it.

The planted faults give answers that are true row by row (each distance
that of its row) but not the nearest, which only `knn_missed` can see:

- `ef-halved`: the graph search explores half as far (ef 64 -> 32);
- `block-skipped`: the reads leave one block of slots, a 64th of the
  live rows, out of their pass (the exact scan's fault).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vssbench import reference  # noqa: E402
from vssbench.system import PortSystem  # noqa: E402


class ControlSystem:
    """Exact search over the live rows by `reference.knn` in TF32."""

    def __init__(self, config: dict, device):
        self.device = torch.device(device)
        self.metric = config["index"]["metric"]
        self.rows = self.ids = None

    def prepare(self) -> float:
        return 0.0

    def stats(self) -> dict:
        return {}

    def build(self, rows: torch.Tensor):
        self.rows = rows.clone()
        self.ids = torch.arange(rows.shape[0], device=self.device)

    def search(self, q, k, ef=None):
        d, i = reference.knn(torch.as_tensor(np.asarray(q), device=self.device), self.rows, k,
                             ids=self.ids, precision="tf32", metric=self.metric)
        return d.cpu().numpy(), i.cpu().numpy()

    def scan_search(self, q, k):
        return self.search(q, k)

    def insert(self, rows, ids):
        self.rows = torch.cat([self.rows, torch.as_tensor(rows, device=self.device)])
        self.ids = torch.cat([self.ids, torch.as_tensor(ids, device=self.device)])

    def delete(self, ids):
        keep = ~torch.isin(self.ids, torch.as_tensor(ids, device=self.device))
        self.rows, self.ids = self.rows[keep], self.ids[keep]

    def close(self):
        self.rows = self.ids = None


class EfHalved(PortSystem):
    """The port's graph search with half its ef."""

    def search(self, q, k, ef):
        return super().search(q, k, max(k, (ef or self.config.ef_search) // 2))


class BlockSkipped(PortSystem):
    """The port's reads over every live row but a block of slots, the
    first `share` of them, left out through the port's own filter."""

    share = 1 / 64

    def _mask(self):
        mask = torch.ones(self.index.capacity, dtype=torch.bool, device=self.device)
        mask[: max(1, int(self.index.count * self.share))] = False
        return mask

    def search(self, q, k, ef):
        d, ids = self.index.search(q, k, ef=ef, filter_mask=self._mask())
        return d.cpu().numpy(), ids.cpu().numpy()

    def scan_search(self, q, k):
        d, ids = self.index.scan_search(q, k, filter_mask=self._mask())
        return d.cpu().numpy(), ids.cpu().numpy()


def _port(cls):
    return lambda config, device: cls(config["index"], config["corpus"]["dims"], device)


SYSTEMS = {
    "control": ControlSystem,
    "port": _port(PortSystem),
    "ef-halved": _port(EfHalved),
    "block-skipped": _port(BlockSkipped),
}


def main(argv=None) -> int:
    from vssbench import cell

    p = argparse.ArgumentParser(description="Read a cell's check numbers under a system.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--system", choices=sorted(SYSTEMS), default="control")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("vssbench control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = cell.run_cell(args.workload, seed, args.seconds, False, "cuda:0",
                          time.perf_counter(), make_system=SYSTEMS[args.system])
        print(json.dumps({"workload": args.workload, "system": args.system, "seed": seed,
                          "correct": r["correct"], "check": r["check"],
                          "recall": r["metrics"].get("recall", {}).get("value")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
