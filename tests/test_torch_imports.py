"""The port stands alone: no module of `vss_tpu_torch`, and not
`chip_smoke.py`, imports JAX or anything of the `vss_tpu` package.

Every file is parsed with `ast`, so the check covers imports inside
functions too, and nothing is imported to run it.
"""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "vss_tpu")


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


@pytest.mark.parametrize("path", _port_files())
def test_no_jax_or_vss_tpu_import(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = sorted({m for m in _imported_modules(tree) if _forbidden(m)})
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("vss_tpu", True), ("vss_tpu.ops", True),
    ("vss_tpu_torch", False), ("vss_tpu_torch.ops", False), ("torch", False),
])
def test_forbidden_names(name, bad):
    assert _forbidden(name) is bad
