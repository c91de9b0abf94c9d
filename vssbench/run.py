"""Runs one cell of BENCHMARK.json once and prints its result line.

    python3 vssbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs a CUDA device: without one (or with fewer than the cell asks for)
it exits with code 2 and prints no result. The last line of standard
output is the result: one JSON object with `correct`, `attempted`,
`failed`, `metrics`, `device` (with `--trace 1` also `breakdown`) and,
last, `check`: each number compared, with its limit. The same numbers
are the last lines of standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache a library may keep goes to a fixed directory of the checkout
_CACHE = os.path.join(_ROOT, ".vssbench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(_CACHE, sub)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# top-level module names that must never be loaded: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "vss_tpu")


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is forbidden (compared whole:
    `vss_tpu_torch` is not `vss_tpu`)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from vssbench import cell

    bench = cell.load_benchmark(_ROOT)
    workload, _ = cell.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"vssbench: {args.workload} needs {workload['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = cell.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           "cuda:0", T_START)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"vssbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        ok = "ok" if v["value"] <= v["limit"] else "FAIL"
        print(f"check {k} {v['value']!r} limit {v['limit']!r} {ok}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
