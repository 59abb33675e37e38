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
                ("native", "interp2d.py"), ("utils", "visuals.py"), ("cli", "eval.py"),
                ("models", "segformer.py"), ("models", "deeplab.py"), ("models", "saliency.py"),
                ("data", "loader.py"), ("data", "lvis.py"), ("data", "cityscapes.py"),
                ("data", "aria_adt.py"), ("data", "odgt.py"), ("cli", "cook.py"),
                ("cli", "eval_odgt.py"), ("models", "segmentation_module.py"),
                ("assets", "ade20k.py"), ("utils", "ade.py"), ("ops", "library.py"),
                ("cli", "export.py"), ("models", "backbones.py"),
                ("models", "legacy_decoders.py"), ("models", "seg_hrnet.py"),
                ("models", "bucketed.py"), ("core", "deformed_sampler.py"), ("core", "gaze.py"),
                ("native", "distance.py"), ("native", "kdtree.py"), ("native", "rotation.py"),
                ("native", "voronoi.py"), ("utils", "observe.py"), ("utils", "torch_tools.py"),
                ("utils", "dynamicfocus.py"), ("utils", "misc.py"), ("utils", "plot.py"),
                ("ops", "quant.py")):
        assert os.path.join("fovealseg_torch", *mod) in names
    for src in ("jfa.cu", "gather.cu", "quant.cu"):
        assert os.path.exists(os.path.join(REPO, "fovealseg_torch", "csrc", src))
    for cfg in ("deform.yaml", "ade20k.yaml"):
        assert os.path.exists(os.path.join(REPO, "fovealseg_torch", "configs", cfg))
    for src in ("spatial.cpp", "distance.cpp", "kdtree.cpp"):
        assert os.path.exists(os.path.join(REPO, "fovealseg_torch", "native", src))
    assert len(names) > 60


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"
