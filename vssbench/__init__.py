"""vssbench: the benchmark of the PyTorch and CUDA port (`vss_tpu_torch`).

One process runs one cell of `BENCHMARK.json` once:

    python3 vssbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name that `BENCHMARK.json`
gives it: `configs/<config>.json` (the deployment), `data/<generator>.py`
(the corpus), `traffic/<traffic>.json` (the step program that `loop.py`
runs), `metrics/<metric>.py` (a reader of the trace or the spans) and
`limits/<cell>.json` (the limits of the numbers that decide `correct`).
`reference.py` is the plain exact search that judges the answers; it
imports nothing of the port. `system.py` is the only module that imports
the port.
"""
