"""Interactive SQL shell: `python -m vss_tpu_torch [--device D] [database-path]`.

A minimal stand-in for the DuckDB shell the reference rides in: one SQL
statement per line against an in-memory (or opened) database on the GPU
(or `--device cpu`). `python -m vss_tpu_torch [--device D] calibrate`
measures the cost model's rates on the device and persists them.

Reproduces `vss_tpu/__main__.py`.
"""
import sys

import numpy as np


def _print_result(res):
    if res is None:
        return
    if "explain" in res and len(res) == 1:
        print(res["explain"][0])
        return
    cols = list(res)
    if not cols:
        print("(empty)")
        return
    n = len(res[cols[0]])
    widths = {
        c: max(len(c), *(len(_fmt(res[c][i])) for i in range(min(n, 40))), 1)
        for c in cols
    }
    print(" | ".join(c.ljust(widths[c]) for c in cols))
    print("-+-".join("-" * widths[c] for c in cols))
    for i in range(min(n, 40)):
        print(" | ".join(_fmt(res[c][i]).ljust(widths[c]) for c in cols))
    if n > 40:
        print(f"... ({n} rows)")


def _fmt(v):
    if isinstance(v, (np.floating, float)):
        return f"{v:.4g}"
    a = np.asarray(v)
    if a.ndim >= 1 and a.size > 8:
        return f"[{a.size}-vec]"
    return str(v)


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    from vss_tpu_torch import BinderError, Database

    device = None
    if argv[:1] == ["--device"] and len(argv) > 1:
        device, argv = argv[1], argv[2:]

    if argv and argv[0] == "calibrate":
        # one-shot cost-model rate probe for this device (persists to
        # ~/.cache/vss_tpu_torch/, loaded by the hybrid planner)
        from vss_tpu_torch.query import cost

        rates = cost.calibrate(device=device)
        print(f"calibrated + persisted to {rates['path']}:")
        for sz, bw in sorted(rates["tape_bw"].items()):
            print(f"  tape_bw[{sz}B] = {bw/1e9:.1f} GB/s")
        for key in ("stream_bw", "random_bw", "gather_bw"):
            print(f"  {key} = {rates[key]/1e9:.1f} GB/s")
        return

    if argv:
        db = Database.open(argv[0], device=device)
        print(f"opened {argv[0]}")
    else:
        db = Database(device=device)
    print("vss_tpu_torch shell — SQL statements, one per line. \\q to quit.")
    while True:
        try:
            line = input("vss> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not line:
            continue
        if line in ("\\q", "exit", "quit"):
            break
        try:
            _print_result(db.sql(line.rstrip(";")))
        except BinderError as e:
            print(f"Binder Error: {e}")
        except Exception as e:  # surface, keep the shell alive
            print(f"Error: {type(e).__name__}: {e}")


if __name__ == "__main__":
    main()
