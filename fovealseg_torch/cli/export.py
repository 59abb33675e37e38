"""Export the serving graph as one ``torch.export`` program (counterpart of
``cli/export.py``).

The whole foveated pipeline (gaze map -> saliency -> grid solve -> warp ->
segment -> inverse warp), with its weights, becomes one program of
``forward(x [B,H,W,3] f32, f [B,2] f32)`` that returns
``infer(argmax_labels=True)["pred_label"]`` ([B,H,W] int32 class ids), or
with ``--scores`` ``infer()["pred_sampled"]`` ([B,H,W,C] f32). Its shapes are
static, as the JAX artifact's are. The hand-written kernels are in the graph
as the registered operators ``torch.ops.fovealseg.*`` (``ops/library.py``):
the program runs them as opaque calls, the CUDA kernels on the card and the
plain versions on the CPU, and counts their launches as an eager call does.
The CLI refuses to write a program that holds none of them.

Usage:
  python -m fovealseg_torch.cli.export --cfg fovealseg_torch/configs/deform.yaml \
      --out model.pt2 [--batch 8 --canvas 640] [--scores] [--device cuda] \
      [--torch-ckpt DIR --torch-epoch N | DIR <training run> TRAIN.start_epoch N]

Load and serve (no model code and no config at the serving site):
  import torch
  import fovealseg_torch.ops  # registers torch.ops.fovealseg.*
  serve = torch.export.load("model.pt2").module()
  masks = serve(images_f32_BHW3, gaze_B2)  # on the device it was exported for

The program runs on the device it was exported for (``--device``). Its f32
matrix products (grid solve, resizes) follow the serving process's
``torch.backends.cuda.matmul`` setting, full f32 by default, where the live
module forces full f32 for them.

``--format torch --out DIR`` writes the reference's 4-file checkpoint set
(``{saliency,compress,encoder,decoder}_epoch_{tag}.pth``) instead, tagged as
the JAX CLI tags it: ``--torch-epoch`` for a ``--torch-ckpt`` source,
``TRAIN.start_epoch`` for a training checkpoint, else ``last``; a tag other
than ``last`` also writes the ``_last`` copies.
"""

from __future__ import annotations

import argparse
import os

import torch

FORMATS = ("pt2", "torch", "stablehlo")


class ServingProgram(torch.nn.Module):
    """The exported function: ``model.infer`` on (frames, gaze), returning
    the labels or, with ``scores``, the full-resolution score map."""

    def __init__(self, model: torch.nn.Module, scores: bool):
        super().__init__()
        self.model = model
        self.scores = scores

    def forward(self, x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        out = self.model.infer(x, f, argmax_labels=not self.scores)
        return out["pred_sampled" if self.scores else "pred_label"]


def export_serving(model: torch.nn.Module, batch: int, canvas: int, scores: bool = False):
    """``torch.export`` of :class:`ServingProgram` at [batch, canvas, canvas]
    frames on the model's device. Traced under ``no_grad``, as ``infer``
    runs, after one eager call at the same shapes: it fills the caches of
    the resize and grid-solver matrices (``core/interpolate.py::eager_cache``),
    which the trace then reads, so they enter the program as device
    constants rather than as a copy from the host on every call."""
    x0 = torch.zeros((batch, canvas, canvas, 3), dtype=torch.float32, device=model.device)
    f0 = torch.full((batch, 2), 0.5, dtype=torch.float32, device=model.device)
    program = ServingProgram(model, scores)
    with torch.no_grad():
        program(x0, f0)
        return torch.export.export(program, (x0, f0), strict=False)


def kernel_ops(program) -> list[str]:
    """The ``fovealseg::`` operators that the program's graph calls, sorted
    (nested graphs included)."""
    found = set()
    for gm in program.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                if node.op == "call_function" and str(node.target).startswith("fovealseg."):
                    found.add(str(node.target).split(".")[1])
    return sorted(found)


def required_ops(cfg, scores: bool) -> list[tuple[str, ...]]:
    """The operators the program must hold: each entry is satisfied by any
    one of its names. The learned warp's 'nearest' inverse warp takes K1 for
    labels and K2 (or K3) with K5 for scores; 'BI' and 'tri' fill with K4 and
    K5."""
    if cfg.MODEL.uniform_sample != "":
        return []
    if cfg.MODEL.rev_deform_interp != "nearest":
        return [("nearest_seed",), ("row_gather",)]
    if scores:
        return [("nearest_payload_packed", "nearest_payload"), ("row_gather",)]
    return [("nearest_class",)]


def load_weights(parser, args, cfg, model) -> tuple[str, object]:
    """The JAX CLI's weight sources in its order: ``--torch-ckpt`` (lenient,
    as the reference loads), then the port's training checkpoint in ``DIR``
    at ``TRAIN.start_epoch`` (strict, with its optimizer state), else the
    seeded init, refused without ``--allow-random``. Returns (source, the
    ``--format torch`` tag)."""
    from fovealseg_torch.train import checkpoint as ckpt

    if args.torch_ckpt:
        ckpt.load_torch_checkpoint(model, args.torch_ckpt, args.torch_epoch)
        return "torch_ckpt", args.torch_epoch
    if cfg.TRAIN.start_epoch > 0 and os.path.isdir(cfg.DIR):
        from fovealseg_torch.train.optim import create_optimizer
        from fovealseg_torch.train.step import init_state

        state = init_state(model, create_optimizer(cfg, model), cfg.TRAIN.seed)
        ckpt.load_checkpoint(cfg.DIR, cfg.TRAIN.start_epoch, state)
        model.eval()
        return "checkpoint", cfg.TRAIN.start_epoch
    if not args.allow_random:
        # exporting hands weights to a downstream consumer: refuse, as the JAX CLI does
        parser.error("no weight source (no --torch-ckpt, and TRAIN.start_epoch/DIR do not name "
                     "a resumable checkpoint): refusing to export RANDOMLY INITIALIZED weights. "
                     "Pass --allow-random for smoke tests.")
    return "random", "last"


def _parse(argv):
    parser = argparse.ArgumentParser(description="fovealseg export (PyTorch port)")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--out", required=True, help="output program path (or directory with "
                                                     "--format torch)")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--canvas", type=int, default=640)
    parser.add_argument("--scores", action="store_true",
                        help="export the full-score pred_sampled instead of argmax labels")
    parser.add_argument("--format", choices=FORMATS, default="pt2",
                        help="'pt2' (default): one torch.export program; 'torch': the "
                             "reference's 4-file .pth checkpoint in the --out directory; "
                             "'stablehlo' is the JAX package's artifact and is refused")
    parser.add_argument("--torch-ckpt", default=None)
    parser.add_argument("--torch-epoch", default="last")
    parser.add_argument("--allow-random", action="store_true",
                        help="permit exporting RANDOMLY INITIALIZED weights (smoke tests only; "
                             "refused otherwise for every --format)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu: the device "
                                                         "the program serves on")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)
    if args.format == "stablehlo":
        parser.error("--format stablehlo is the JAX package's jax.export artifact; the port "
                     "writes a torch.export program (--format pt2, the default) or the "
                     "4-file .pth set (--format torch)")
    from fovealseg_torch.configs import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if (args.format == "pt2" and cfg.MODEL.rev_deform_interp == "tri"
            and cfg.MODEL.uniform_sample == "" and cfg.TPU.tri_exact):
        # the JAX CLI exports infer()'s device splat fill, which is what TPU.tri_exact False
        # serves; the exact fill plans on the host (native/interp2d.py), outside any program
        parser.error("MODEL.rev_deform_interp 'tri' with TPU.tri_exact True (the exact fill) "
                     "plans each frame's Delaunay triangulation on the host and cannot be in "
                     "a program; pass TPU.tri_exact False to export the device splat fill "
                     "(what the JAX CLI's artifact computes), or use 'nearest'")
    return parser, args, cfg


def main(argv=None):
    """Write the program (or the 4-file set); returns a summary dict (with
    the ``torch.export.ExportedProgram`` under ``program``)."""
    parser, args, cfg = _parse(argv)

    from fovealseg_torch import resolve_device
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.layers import init_weights

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if cfg.TPU.compute_dtype == "bfloat16" else torch.float32
    model = DeformSegmentation(DeformConfig.from_cfg(cfg), dtype=dtype, device=device)
    init_weights(model, torch.Generator().manual_seed(cfg.TRAIN.seed))
    source, tag = load_weights(parser, args, cfg, model)

    if args.format == "torch":
        from fovealseg_torch.train.checkpoint import save_torch_checkpoint

        written = save_torch_checkpoint(args.out, tag, model, also_last=str(tag) != "last")
        print(f"wrote {len(written)} reference-format .pth files under {args.out} (epoch tag "
              f"{tag}" + (" + _last mirrors)" if str(tag) != "last" else ")"), flush=True)
        return {"format": "torch", "files": written, "source": source, "tag": tag}

    import fovealseg_torch.ops  # noqa: F401  (the operators the program calls)

    program = export_serving(model, args.batch, args.canvas, args.scores)
    ops = kernel_ops(program)
    missing = [alts for alts in required_ops(cfg, args.scores) if not set(alts) & set(ops)]
    if not ops or missing:
        raise SystemExit(f"refusing to write {args.out}: the program holds the kernel operators "
                         f"{ops or 'none'}, and it must hold "
                         f"{' and '.join('/'.join(a) for a in missing) or 'at least one'}: "
                         f"without them it would serve through no hand-written kernel")
    torch.export.save(program, args.out)
    sig = program.graph_signature
    inputs = [f"{n.name}: {list(n.meta['val'].shape)} {n.meta['val'].dtype}"
              for n in program.graph.nodes if n.op == "placeholder" and n.name in sig.user_inputs]
    (out_node,) = [n for n in program.graph.nodes if n.op == "output"]
    outputs = [f"{list(a.meta['val'].shape)} {a.meta['val'].dtype}" for a in out_node.args[0]]
    size = os.path.getsize(args.out)
    print(f"wrote {args.out}: {size / 1e6:.1f} MB ({source} weights, {str(dtype)[6:]}, "
          f"{device.type}), in={inputs}, out={outputs}, kernel operators="
          f"{['fovealseg::' + o for o in ops]}", flush=True)
    return {"format": "pt2", "path": args.out, "bytes": size, "inputs": inputs,
            "outputs": outputs, "ops": ops, "source": source, "program": program}


if __name__ == "__main__":
    main()
