"""One short run of a cell through the command, on the card. Skips
without one (decided in the fixture, never at import). On the card:

    python -m pytest -o addopts="" -m cuda vssbench/tests/test_vssbench_cuda.py -q
"""
import json
import os
import subprocess
import sys

import pytest

from .tiny import BENCH, ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark runs only on the card")


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(card):
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                        "sift1m.scan-k100", "--seed", str(2**31 + 5), "--seconds", "3",
                        "--trace", "0"], capture_output=True, text=True, timeout=900, cwd=ROOT)
    tail = p.stderr[-4000:]
    assert p.returncode == 0, tail
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["check"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1, r["device"]
    assert {"qps", "p95_ms", "recall", "setup_s"} <= set(r["metrics"]), r["metrics"]
    assert p.stderr.strip().splitlines()[-1].startswith("check "), tail
