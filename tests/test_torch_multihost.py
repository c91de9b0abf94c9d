"""The port's multi-process runtime (`vss_tpu_torch/parallel/multihost.py`):
two OS processes on the CPU, each holding 2 shard slots, joined through
`torch.distributed` (gloo) into one 4-slot global mesh, as
`tests/test_multihost.py` joins two JAX processes.

Each rank builds only its own shards (the bulk builder and the wave
builder), searches them, and the per-shard lists travel through
`dist.all_gather`. Both ranks must return the same ids, and those must
equal the single-process index over `make_mesh(4, device="cpu")` with the
same seed (the vectors are small integers: distances are exact, so ids
are compared for equality, distances within rtol 1e-5, atol 1e-4). Each
child has a hard timeout, and the children are killed if the test fails.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from vss_tpu_torch.index import HNSWConfig
from vss_tpu_torch.parallel import ShardedHNSWIndex, make_mesh

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CHILD_TIMEOUT_S = 120

_SCRIPT = r"""
import numpy as np

from vss_tpu_torch.index import HNSWConfig
from vss_tpu_torch.parallel import ShardedHNSWIndex


def run(mesh):
    rng = np.random.default_rng(0)  # the same data in every process (SPMD)
    vecs = rng.integers(-12, 13, (256, 8)).astype(np.float32)
    cfg = HNSWConfig(dims=8, m=8, ef_construction=48)
    out = {}
    idx = ShardedHNSWIndex.build(vecs, cfg, mesh, method="exact")
    d, rows, st = idx.search(vecs[:8], k=3, with_stats=True)
    out["exact"] = [rows.tolist(), d.tolist(), st["per_shard_evals"].tolist()]
    _, rows = idx.scan_search(vecs[:8], k=3)
    out["scan"] = rows.tolist()
    widx = ShardedHNSWIndex.build(vecs, cfg, mesh, wave_size=64, method="wave")
    _, rows = widx.search(vecs[:8], k=3)
    out["wave"] = rows.tolist()
    # writes: every rank keeps the same bookkeeping, each its own shards
    idx.insert(vecs[:6] + 100.0, np.arange(1000, 1006))
    idx.delete([3, 1002])
    _, rows = idx.search(np.concatenate([vecs[:8], vecs[:6] + 100.0]), k=3)
    out["after_writes"] = rows.tolist()
    out["count"] = idx.count
    return out
"""

_WORKER = _SCRIPT + r"""
import json, os
import torch
import torch.distributed as dist

from vss_tpu_torch.parallel import make_mesh, multihost

torch.set_num_threads(1)
# VSS_COORDINATOR / VSS_NUM_PROCESSES / VSS_PROCESS_ID from the environment
mesh = multihost.initialize(local_slots=make_mesh(2, device="cpu"), timeout_s=60)
res = run(mesh)
res.update(rank=dist.get_rank(), owners=list(mesh.owners),
           local=multihost.local_shard_indices(mesh), multi=multihost.is_multiprocess(mesh))
dist.destroy_process_group()
print("RESULT " + json.dumps(res), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(code, env_extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=_REPO, **env_extra)
    return subprocess.Popen([sys.executable, "-c", code], env=env, cwd=_REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_two_process_build_and_search_equal_single_process():
    port = _free_port()
    procs = [_spawn(_WORKER, {"VSS_COORDINATOR": f"127.0.0.1:{port}",
                              "VSS_NUM_PROCESSES": "2", "VSS_PROCESS_ID": str(r)})
             for r in range(2)]
    results = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=_CHILD_TIMEOUT_S)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
            r = json.loads(line[len("RESULT "):])
            results[r["rank"]] = r
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert set(results) == {0, 1}
    assert results[0]["owners"] == results[1]["owners"] == [0, 0, 1, 1]
    assert results[0]["local"] == [0, 1] and results[1]["local"] == [2, 3]
    assert results[0]["multi"] and results[1]["multi"]
    # the single-process index over four slots, same data and seed
    ns = {}
    exec(_SCRIPT, ns)
    torch.set_num_threads(1)
    want = ns["run"](make_mesh(4, device="cpu"))
    for r in (0, 1):
        got = results[r]
        for key in ("scan", "wave", "after_writes", "count"):
            assert got[key] == want[key], (r, key)
        assert got["exact"][0] == want["exact"][0]
        assert got["exact"][2] == want["exact"][2]
        np.testing.assert_allclose(got["exact"][1], want["exact"][1], rtol=1e-5, atol=1e-4)
    # searching for indexed vectors finds them, merged across processes
    assert [row[0] for row in want["exact"][0]] == list(range(8))
    assert want["after_writes"][3][0] != 3
    assert want["after_writes"][8 + 2][0] != 1002


def test_named_backend_that_fails_raises():
    """An explicit backend that cannot start raises: nothing falls back
    to another (here NCCL, which this PyTorch build or host lacks)."""
    code = (
        "import torch\n"
        "from vss_tpu_torch.parallel import multihost\n"
        "try:\n"
        f"    multihost.initialize('127.0.0.1:{_free_port()}', 1, 0, backend='nccl',\n"
        "                         local_slots=['cpu'], timeout_s=20)\n"
        "except Exception as e:\n"
        "    print('RAISED', type(e).__name__)\n"
        "else:\n"
        "    import torch.distributed as dist\n"
        "    print('STARTED', dist.get_backend())\n"
    )
    p = _spawn(code, {})
    try:
        out, err = p.communicate(timeout=_CHILD_TIMEOUT_S)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 0, err[-3000:]
    if torch.cuda.is_available():
        return  # a card may well run NCCL: nothing to check
    assert "RAISED" in out, out + err[-2000:]


def test_single_process_mesh_helpers():
    from vss_tpu_torch.parallel import multihost

    m = make_mesh(3, device="cpu")
    assert not multihost.is_multiprocess(m)
    assert multihost.local_shard_indices(m) == [0, 1, 2]
    assert multihost.global_mesh(m).devices == m.devices
    placed = multihost.place_sharded(m, np.arange(6).reshape(3, 2))
    assert [p.tolist() for p in placed] == [[0, 1], [2, 3], [4, 5]]
    idx = ShardedHNSWIndex(HNSWConfig(dims=2), m)
    assert idx.device == torch.device("cpu") and idx.n_shards == 3
