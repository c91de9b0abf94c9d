"""The port stands alone: no module of `vss_tpu_torch`, and not
`chip_smoke.py`, imports JAX, ml_dtypes or anything of the `vss_tpu`
package.

Every file is parsed with `ast`, so the check covers imports inside
functions too, and nothing is imported to run it. A fresh interpreter
then imports every module of the port and must end with none of those
in `sys.modules`.
"""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "vss_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "vss_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(os.path.relpath(f, ROOT) for f in files)


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("__import__", "import_module")
                and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_has_modules():
    files = _port_files()
    assert "chip_smoke.py" in files
    assert len(files) > 10
    for module in ("build", "select", "host_build", "join", "dense", "search"):
        assert os.path.join("vss_tpu_torch", "index", f"{module}.py") in files
    for module in ("wal", "blockfile", "serialize"):
        assert os.path.join("vss_tpu_torch", "storage", f"{module}.py") in files
    for module in ("functions", "ir", "table", "rewrite", "exec", "macros", "api", "cost",
                   "sql"):
        assert os.path.join("vss_tpu_torch", "query", f"{module}.py") in files
    for module in ("mesh", "multihost", "sharded", "sharded_build", "__init__"):
        assert os.path.join("vss_tpu_torch", "parallel", f"{module}.py") in files
    assert os.path.join("vss_tpu_torch", "entry.py") in files
    assert os.path.join("vss_tpu_torch", "utils", "datasets.py") in files
    assert os.path.join("vss_tpu_torch", "__main__.py") in files
    assert os.path.join("vss_tpu_torch", "testing", "sqllogic.py") in files
    assert os.path.exists(os.path.join(ROOT, "vss_tpu_torch", "csrc", "blockstore.cpp"))


def test_importing_every_module_loads_no_jax():
    """Import every module of the port in a fresh interpreter; none of
    jax, ml_dtypes or vss_tpu may be loaded afterwards."""
    modules = sorted(
        p[:-3].replace(os.sep, ".").replace(".__init__", "")
        for p in _port_files() if p.startswith("vss_tpu_torch")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'vss_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    for m in ("vss_tpu_torch.query.sql", "vss_tpu_torch.__main__", "vss_tpu_torch.entry",
              "vss_tpu_torch.parallel.sharded", "vss_tpu_torch.parallel.multihost",
              "vss_tpu_torch.utils.datasets"):
        assert m in modules


@pytest.mark.parametrize("path", _port_files())
def test_no_jax_or_vss_tpu_import(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = sorted({m for m in _imported_modules(tree) if _forbidden(m)})
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("vss_tpu", True), ("vss_tpu.ops", True),
    ("ml_dtypes", True),
    ("vss_tpu_torch", False), ("vss_tpu_torch.ops", False), ("torch", False),
])
def test_forbidden_names(name, bad):
    assert _forbidden(name) is bad
