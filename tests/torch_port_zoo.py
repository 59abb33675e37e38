"""Shared helpers of the port's encoder and saliency-net tests
(``test_torch_port_{segformer,deeplab,zoom,encoders_slice}.py``).

The JAX modules are not initialised by XLA: ``jax.eval_shape`` gives their
variable trees (no compile), :func:`seeded_variables` fills them from a numpy
seed, and the JAX package's own ``export_torch_state_dict`` carries them into
the port, loaded with ``strict=True``. Each side then runs the same seeded
input. Dropout is switched off on both sides by :func:`no_dropout`.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.train.checkpoint import export_torch_state_dict
from fovealseg_torch.models import layers
from fovealseg_torch.train.checkpoint import from_jax_variables


@contextlib.contextmanager
def no_dropout():
    """``flax.linen.Dropout`` and the port's ``Dropout`` as the identity."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(layers.Dropout, "forward", lambda self, x: x)
        yield


@pytest.fixture(scope="module")
def two_threads_no_dropout():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with no_dropout():
        yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def no_tensorflow():
    """``import tensorflow`` fails in the block, so that the port's
    TensorBoard writer (``torch.utils.tensorboard``) takes TensorBoard's own
    stand-in for TensorFlow, as the rank processes of
    ``test_torch_parallel_cli.py`` do: importing TensorFlow costs a process
    ~20 s, and the event files are written all the same."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorflow", None)
        yield


def variable_shapes(module, *args, **kwargs) -> dict:
    """{collection: {path tuple: shape}} of ``module.init`` through
    ``jax.eval_shape`` (traced, not compiled)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kwargs)
    out = {}
    for col, tree in shapes.items():
        out[col] = {tuple(p.key for p in path): tuple(leaf.shape)
                    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return out


def seeded_variables(module, *args, seed: int = 0, **kwargs) -> dict:
    """``module``'s variables filled from ``np.random.default_rng(seed)``:
    kernels normal with variance 2 / fan_in (1 / fan_in for a Dense), scales
    1 + N(0, 0.1^2), biases and means N(0, 0.1^2), variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kwargs)

    def fill(path, leaf):
        name, shape = path[-1].key, tuple(leaf.shape)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            gain = 2.0 if len(shape) == 4 else 1.0
            v = rng.normal(0.0, np.sqrt(gain / fan_in), shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = 0.1 * rng.normal(size=shape)
        return v.astype(np.float32)

    return {col: jax.tree_util.tree_map_with_path(fill, tree) for col, tree in shapes.items()}


def port_state(variables: dict, top: str = "encoder") -> dict:
    """The JAX package's export of one sub-network's variables (as the
    ``top`` subtree of a ``DeformSegmentation``) as a torch state dict; also
    checks that the port's ``from_jax_variables`` gives the same tensors."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    kind = {"encoder": "encoder", "decoder": "decoder", "localization": "saliency",
            "net_compress": "compress"}[top]
    exp = export_torch_state_dict({top: params}, {top: stats} if stats else {})[kind]
    ours = from_jax_variables({top: params}, {top: stats} if stats else {})
    assert set(ours) == {f"{top}.{k}" for k in exp}
    for k, v in exp.items():
        np.testing.assert_array_equal(ours[f"{top}.{k}"].numpy(), v, err_msg=k)
    return {k: torch.from_numpy(np.array(v)) for k, v in exp.items()}


def jax_forward(module, variables, x: np.ndarray, train: bool):
    """(output as f32 numpy, updated batch_stats or None) of a jitted apply."""
    def run(v, x):
        if train:
            return module.apply(v, x, train=True, mutable=["batch_stats"])
        return module.apply(v, x, train=False), None

    out, upd = jax.jit(run)(variables, jnp.asarray(x))
    if isinstance(out, (list, tuple)):
        (out,) = out
    stats = None if not upd else jax.tree.map(np.asarray, upd["batch_stats"])
    return np.asarray(jnp.asarray(out, jnp.float32)), stats


def port_forward(module: torch.nn.Module, x: np.ndarray, train: bool) -> np.ndarray:
    """The port module's output (NHWC, f32 numpy) on the NHWC input ``x``."""
    module.train(train)
    with torch.no_grad():
        out = module(torch.from_numpy(x).permute(0, 3, 1, 2))
    if isinstance(out, (list, tuple)):
        (out,) = out
    return out.float().permute(0, 2, 3, 1).numpy()


def port_forward64(module: torch.nn.Module, x: np.ndarray, train: bool) -> np.ndarray:
    """The same function in float64: a copy of ``module`` with f64 weights
    computing in f64, on ``x`` in f64."""
    m = copy.deepcopy(module).double()
    for sub in m.modules():
        if hasattr(sub, "compute_dtype"):
            sub.compute_dtype = torch.float64
        if hasattr(sub, "dtype") and not callable(sub.dtype):
            sub.dtype = torch.float64
    m.train(train)
    with torch.no_grad():
        out = m(torch.from_numpy(x).double().permute(0, 3, 1, 2))
    if isinstance(out, (list, tuple)):
        (out,) = out
    return out.permute(0, 2, 3, 1).numpy()


def assert_as_accurate(got, ref, ref64, direct: float, floor: float) -> None:
    """The port's output ``got`` is within ``direct`` of the JAX package's
    ``ref`` (``rel_err``), and no farther from the float64 forward ``ref64``
    than twice the JAX package's distance plus ``floor``."""
    err, port64, jax64 = rel_err(got, ref), rel_err(got, ref64), rel_err(ref, ref64)
    assert err <= direct, f"port vs JAX {err:.3g} > {direct}"
    assert port64 <= 2.0 * jax64 + floor, (
        f"port {port64:.3g} from float64, JAX {jax64:.3g}")


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / max(float(np.max(np.abs(ref))), 1e-30))


def running_stats_err(module: torch.nn.Module, stats: dict, top: str = "encoder") -> float:
    """The largest ``rel_err`` of the port's BN running statistics against the
    JAX package's updated ``batch_stats``."""
    want = from_jax_variables({}, {top: stats})
    sd = module.state_dict()
    errs = [rel_err(sd[k[len(top) + 1:]].numpy(), v.numpy()) for k, v in want.items()
            if "num_batches" not in k]
    assert errs
    return max(errs)


def key_coverage(port: torch.nn.Module, shapes: dict) -> None:
    """Every port key maps onto one JAX leaf with the transposed shape, and
    every JAX leaf is reached (``shapes`` from :func:`variable_shapes` of the
    bare module)."""
    flat = {(col,) + path: shape for col, tree in shapes.items() for path, shape in tree.items()}
    leaf_of = {"running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}
    seen = set()
    for key, t in port.state_dict().items():
        *mod, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        if leaf == "weight":
            col, jleaf = "params", "kernel" if t.dim() in (2, 4) else "scale"
        else:
            col, jleaf = leaf_of.get(leaf, ("params", leaf))
        path = ".".join(mod)
        matches = [p for p in flat if p[0] == col and ".".join(p[1:-1]) == path
                   and p[-1] == jleaf]
        assert len(matches) == 1, key
        js = flat[matches[0]]
        want = (js[3], js[2], js[0], js[1]) if t.dim() == 4 else js[::-1]
        assert tuple(t.shape) == want, key
        seen.add(matches[0])
    assert seen == set(flat), sorted(set(flat) - seen)[:5]


# ------------------------------------------------------------------ the slice
#
# ``DeformSegmentation`` at the tiny size of ``test_torch_port_slice.py`` with
# each new encoder at a cut depth, or the tiny HRNet with a ResNetZoom
# saliency: model -> (MODEL.arch_encoder, MODEL.fc_dim, MODEL.saliency_net).

SLICE_TINY = dict(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16),
                  gaussian_radius=5, num_class=51)
SLICE_MODELS = {"segformer": ("segformer", 80, "fovsimple"),
                "deeplab": ("deeplab", 960, "fovsimple"),
                **{name: ("hrnetv2_nodownsp_tiny", 960, name)
                   for name in ("resnet18", "resnet18_nonsyn", "resnet18_stride1",
                                "resnet10_nonsyn")}}


def _jitted(module):
    """``module`` rebuilt as an instance of its class under
    ``flax.linen.jit`` (``train`` static): the same variables and arithmetic,
    compiled as one program inside an eager ``apply``."""
    fields = {f.name: getattr(module, f.name) for f in dataclasses.fields(module)
              if f.name not in ("parent", "name")}
    return nn.jit(type(module), static_argnames=("train",))(**fields)


@contextlib.contextmanager
def cut_encoders():
    """The JAX and port builders cut for the CPU: ``segformer`` builds
    ``TINY_MIT`` (``tests/test_encoders.py``, 80 channels) and ``deeplab``
    one Bottleneck per layer, both with drop path off. Every JAX sub-network
    runs under ``flax.linen.jit``, so that the JAX package's eager ``infer``
    compiles each as one program instead of op by op; their variables and
    arithmetic are the modules' own."""
    from fovealseg_tpu.models import builder as jax_builder
    from fovealseg_tpu.models.deeplab import DeepLabEncoder as JaxDeepLab
    from fovealseg_tpu.models.segformer import SegFormerEncoder as JaxSegFormer
    from fovealseg_torch.models import builder
    from fovealseg_torch.models.deeplab import DeepLabEncoder
    from fovealseg_torch.models.segformer import SegFormerEncoder
    from tests.test_encoders import TINY_MIT

    jax_build, port_build = jax_builder.build_encoder, builder.build_encoder

    def jax_cut(arch, fc_dim=960, axis_name=None, dtype=jnp.float32):
        if arch == "segformer":
            return _jitted(JaxSegFormer(cfg=TINY_MIT, drop_path_rate=0.0, dtype=dtype))
        if arch == "deeplab":
            return _jitted(JaxDeepLab(axis_name=axis_name, dtype=dtype, layers=(1, 1, 1, 1)))
        return _jitted(jax_build(arch, fc_dim, axis_name, dtype))

    def port_cut(arch, fc_dim=960, dtype=torch.float32):
        if arch == "segformer":
            return SegFormerEncoder(TINY_MIT, drop_path_rate=0.0, dtype=dtype)
        if arch == "deeplab":
            return DeepLabEncoder(dtype=dtype, layers=(1, 1, 1, 1))
        return port_build(arch, fc_dim, dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_builder, "build_encoder", jax_cut)
        mp.setattr(builder, "build_encoder", port_cut)
        for fn in ("build_decoder", "build_net_saliency", "build_net_compress"):
            build = getattr(jax_builder, fn)
            mp.setattr(jax_builder, fn, lambda *a, build=build, **k: _jitted(build(*a, **k)))
        yield


def slice_config(name: str, **over) -> dict:
    arch, fc_dim, sal = SLICE_MODELS[name]
    return dict(SLICE_TINY, arch_encoder=arch, fc_dim=fc_dim, saliency_net=sal, **over)


def slice_data():
    """Two 64x64 frames and gaze points from a seed."""
    rng = np.random.default_rng(23)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    f = rng.uniform(0.2, 0.8, (2, 2)).astype(np.float32)
    return x, f


_SLICE_BASE = {}


def slice_variables(name: str) -> dict:
    """The seeded variables of the (cut) JAX model ``name``, with the
    decoder's background head moved so that the labels split each frame: the
    mask conv's bias minus the median of its pre-activation on
    :func:`slice_data` (the mask then straddles 0) and the background class's
    bias + 100. Call inside :func:`cut_encoders`."""
    from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
    from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation

    from fovealseg_tpu.models import builder as jax_builder

    x, f = slice_data()
    arch, _, sal = SLICE_MODELS[name]
    if arch == "hrnetv2_nodownsp_tiny":
        # one trace of the tiny HRNet model; the saliency and compress nets
        # traced alone
        if "hrnet" not in _SLICE_BASE:
            _SLICE_BASE["hrnet"] = seeded_variables(
                JaxDeform(config=JaxConfig(**slice_config(name))), jnp.asarray(x),
                jnp.asarray(f), seed=12)
        v = copy.deepcopy(_SLICE_BASE["hrnet"])
        for top, net, shape in (("localization", jax_builder.build_net_saliency(sal),
                                 (2, 16, 16, 5)),
                                ("net_compress", jax_builder.build_net_compress(sal),
                                 (2, 1, 1, 256))):
            sub = seeded_variables(net, jnp.zeros(shape), seed=13)
            v["params"][top] = sub["params"]
            v["batch_stats"].pop(top, None)
            if "batch_stats" in sub:
                v["batch_stats"][top] = sub["batch_stats"]
    else:
        v = seeded_variables(JaxDeform(config=JaxConfig(**slice_config(name))), jnp.asarray(x),
                             jnp.asarray(f), seed=12)
    model = DeformSegmentation(DeformConfig(**slice_config(name)), device="cpu")
    model.load_state_dict(from_jax_variables(v["params"], v["batch_stats"]), strict=True)
    seen = []
    hook = model.decoder.conv_last.register_forward_hook(lambda m, i, o: seen.append(o))
    with torch.no_grad():
        model(torch.from_numpy(x), torch.from_numpy(f))
    hook.remove()
    dec = v["params"]["decoder"]
    dec["conv_last"]["bias"] = dec["conv_last"]["bias"] - np.float32(seen[0].median())
    dec["cls_net"]["fc"]["bias"][50] += 100.0
    return v


def train_step_update_errors(name: str) -> tuple[float, float, dict]:
    """One SGD train step of the (cut) model ``name`` on both sides from
    :func:`slice_variables`, dropout off, where the warped image is bit-equal
    on both sides (``MODEL.uniform_sample 'BI'``) and all four groups train
    (the joint edge loss), at ``lr_mult`` 1e-5 (as
    ``test_torch_port_train.py``'s multi-step test). Returns (port loss, JAX
    loss, {(group, stats): the port's update's distance from the JAX one
    over its norm}). Call inside :func:`cut_encoders`."""
    from fovealseg_tpu.configs import get_default_cfg as jax_default_cfg
    from fovealseg_tpu.data.synthetic import make_batch
    from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
    from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
    from fovealseg_tpu.train.optim import create_optimizer as jax_create_optimizer
    from fovealseg_tpu.train.step import LossConfig as JaxLossConfig
    from fovealseg_tpu.train.step import TrainState as JaxTrainState
    from fovealseg_tpu.train.step import make_train_step as jax_make_train_step
    from fovealseg_torch.configs import get_default_cfg
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.optim import GROUPS, create_optimizer, make_stage_schedules

    arch, fc_dim, sal = SLICE_MODELS[name]
    opts = ["TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size", "(16,16)",
            "MODEL.gaussian_radius", "5", "TRAIN.epoch_iters", "10", "MODEL.arch_encoder", arch,
            "MODEL.fc_dim", str(fc_dim), "MODEL.saliency_net", sal, "TRAIN.optim", "sgd",
            "MODEL.uniform_sample", "BI", "TRAIN.deform_joint_loss", "True",
            *sum([[f"TRAIN.lr_mult_{g}", "1e-5"] for g in ("encoder", "decoder", "saliency",
                                                            "compress")], [])]
    jc, pc = [], []
    for make, out in ((jax_default_cfg, jc), (get_default_cfg, pc)):
        c = make()
        c.merge_from_file("fovealseg_torch/configs/deform.yaml")
        c.merge_from_list(opts)
        c.TRAIN.max_iters = c.TRAIN.epoch_iters * c.TRAIN.num_epoch
        out.append(c)
    (jc,), (pc,) = jc, pc
    v = slice_variables(name)
    batch = make_batch(np.random.default_rng(41), 2, canvas=64)
    with no_dropout():
        jm = JaxDeform(config=JaxConfig.from_cfg(jc))
        tx = jax_create_optimizer(jc)
        state = JaxTrainState(v["params"], v["batch_stats"], tx.init(v["params"]), jnp.int32(0))
        step = jax.jit(jax_make_train_step(jm, tx, JaxLossConfig.from_cfg(jc)))
        state, mets = step(state, {k: jnp.asarray(t) for k, t in batch.items()},
                           jax.random.PRNGKey(1))
        ref = from_jax_variables(jax.tree.map(np.asarray, state.params),
                                 jax.tree.map(np.asarray, state.batch_stats))
        model = DeformSegmentation(DeformConfig.from_cfg(pc), device="cpu")
        model.load_state_dict(from_jax_variables(v["params"], v["batch_stats"]), strict=True)
        pstate = S.init_state(model, create_optimizer(pc, model), 0)
        pstep = S.make_train_step(S.LossConfig.from_cfg(pc), make_stage_schedules(pc))
        loss = float(pstep(pstate, {k: torch.from_numpy(t) for k, t in batch.items()})["loss"])
    got = {k: t.detach() for k, t in model.state_dict().items()}
    old = from_jax_variables(v["params"], v["batch_stats"])

    def groups(sd, stats):
        return {g: np.concatenate([np.asarray(sd[k], np.float64).ravel() for k in sorted(sd)
                                   if k.startswith(sub + ".") and "num_batches" not in k
                                   and ("running_" in k) == stats] or [np.zeros(0)])
                for g, sub, _, _ in GROUPS}

    errs = {}
    for stats in (False, True):
        g, r, o = groups(got, stats), groups(ref, stats), groups(old, stats)
        for group in g:
            if o[group].size:
                d = r[group] - o[group]
                errs[group, stats] = float(np.linalg.norm(g[group] - o[group] - d)
                                           / max(np.linalg.norm(d), 1e-300))
    return loss, float(mets["loss"]), errs
