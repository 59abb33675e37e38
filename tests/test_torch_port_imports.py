"""Port: the PyTorch package and the card smoke import neither JAX nor the
JAX package, checked on the source with ``ast`` (imports inside functions
included)."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fovealseg_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "fovealseg_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_sources_exist():
    names = {os.path.relpath(p, REPO) for p in _sources()}
    assert "chip_smoke.py" in names
    for mod in (("ops", "jfa.py"), ("ops", "gather.py"), ("core", "unwarp.py"),
                ("core", "warp.py"), ("core", "grid.py"), ("core", "metrics.py"),
                ("core", "edges.py"), ("data", "synthetic.py"), ("native", "spatial.py"),
                ("native", "interp2d.py"), ("utils", "visuals.py"), ("cli", "eval.py")):
        assert os.path.join("fovealseg_torch", *mod) in names
    for src in ("jfa.cu", "gather.cu"):
        assert os.path.exists(os.path.join(REPO, "fovealseg_torch", "csrc", src))
    assert os.path.exists(os.path.join(REPO, "fovealseg_torch", "configs", "deform.yaml"))
    assert os.path.exists(os.path.join(REPO, "fovealseg_torch", "native", "spatial.cpp"))
    assert len(names) > 30


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"
