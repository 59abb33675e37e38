"""Data cooking CLI of the port (counterpart of ``cli/cook.py``).

  python -m fovealseg_torch.cli.cook lvis --train-json T.json --valid-json V.json \
      --out COOK --sample-num 60000

One entry point over the cookers in ``fovealseg_torch.data``, with the JAX
CLI's subcommands and flags:

  lvis            PreprocessLVIS (``data/lvis.py``)
  cityscapes      PreprocessCityscapes, the gaze-crop cooker (``data/cityscapes.py``)
  cityscapes-rgb  PreprocessCityscapesRGBLabel, the centre-crop cooker
  aria-summary    the Aria ADT cache summary (``smry.json``, ``data/aria_adt.py``)

``lvis``: each ``--sample-num N`` cooks the train partition with marker
``{prefix}{N}`` and the valid partition with ``N // 5`` samples under marker
``{prefix}{N // 5}``, into ``<out>/<partition>/<marker>/``, the layout that
``DATASET.dataset_marker_{train,valid}`` reads at train and eval time. The
cooked files are byte-equal to the JAX CLI's for the same seed. Host only:
nothing here touches a device.
"""

from __future__ import annotations

import argparse
import ast
import os


def _hw(text: str) -> tuple:
    v = ast.literal_eval(text)
    if not (isinstance(v, (tuple, list)) and len(v) == 2):
        raise argparse.ArgumentTypeError(f"expected '(H, W)', got {text!r}")
    return int(v[0]), int(v[1])


def _cook_lvis(args) -> int:
    from fovealseg_torch.data.lvis import PreprocessLVIS

    jsons = {"train": args.train_json, "valid": args.valid_json}
    for part in args.dataset_partition:
        if part not in jsons:
            raise SystemExit(f"unknown partition {part!r} (train/valid)")
        if not jsons[part]:
            raise SystemExit(f"partition {part!r} requested but --{part}-json not given")
    total = 0
    # one PreprocessLVIS per partition: constructing it parses the full LVIS
    # annotation json (~1 GB for train), so hoist it out of the sample_num loop
    pres = {
        part: PreprocessLVIS(
            jsons[part], os.path.join(args.out, part),
            canvas=args.canvas, seed=args.seed,
        )
        for part in args.dataset_partition
    }
    for n_train in args.sample_num:
        for part in args.dataset_partition:
            n = n_train if part == "train" else n_train // 5
            marker = f"{args.marker_prefix}{n}"
            written = pres[part].make_n_samples(n, marker=marker)
            total += len(written)
            print(f"lvis {part}/{marker}: {len(written)}/{n} samples "
                  f"-> {os.path.join(args.out, part, marker)}")
    return 0 if total else 1


def _cook_cityscapes(args) -> int:
    from fovealseg_torch.data.cityscapes import PreprocessCityscapes

    pre = PreprocessCityscapes(
        gtfine_dir=args.gtfine, out_dir=args.out, image_dir=args.images,
        canvas_hw=args.canvas, crop_hw=args.crop, seed=args.seed,
    )
    written = (pre.make_N_samples(args.n, marker=args.marker) if args.n > 0
               else pre.cook(marker=args.marker))
    print(f"cityscapes {args.marker}: {len(written)} samples -> {args.out}")
    return 0 if written else 1


def _cook_cityscapes_rgb(args) -> int:
    from fovealseg_torch.data.cityscapes import PreprocessCityscapesRGBLabel

    pre = PreprocessCityscapesRGBLabel(
        x_dir=args.x_dir, y_dir=args.y_dir, out_dir=args.out, crop_hw=args.crop,
    )
    written = pre.cook(max_samples=args.max_samples)
    print(f"cityscapes-rgb: {len(written)} X/Y pairs -> {args.out}")
    return 0 if written else 1


def _aria_summary(args) -> int:
    from fovealseg_torch.data.aria_adt import make_cache_summary

    rows = make_cache_summary(args.cache_dir, args.out)
    print(f"aria-summary: {len(rows)} entries -> "
          f"{args.out or os.path.join(args.cache_dir, 'smry.json')}")
    return 0 if rows else 1


def main(argv=None):
    parser = argparse.ArgumentParser(description="fovealseg data cooking")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("lvis", help="cook LVIS 50-class gaze samples")
    p.add_argument("--train-json", help="lvis_v1_train.json path")
    p.add_argument("--valid-json", help="lvis_v1_val.json path")
    p.add_argument("--out", required=True, help="cook root (DATASET.data_cook_root)")
    p.add_argument("--sample-num", type=int, nargs="+", required=True,
                   help="train sample counts; valid cooks count//5 (reference rule)")
    p.add_argument("--dataset-partition", nargs="+", default=["train", "valid"])
    p.add_argument("--marker-prefix", default="sp")
    p.add_argument("--canvas", type=int, default=640)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=_cook_lvis)

    p = sub.add_parser("cityscapes", help="cook Cityscapes gaze-crop samples (b3)")
    p.add_argument("--gtfine", required=True, help="gtFine/<split> polygon dir")
    p.add_argument("--images", default=None, help="leftImg8bit/<split> frame dir")
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=0,
                   help=">0: round-robin N samples; 0: one sample per item")
    p.add_argument("--marker", default="default")
    p.add_argument("--canvas", type=_hw, default=(1024, 2048))
    p.add_argument("--crop", type=_hw, default=(512, 1024))
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=_cook_cityscapes)

    p = sub.add_parser("cityscapes-rgb", help="cook Cityscapes RGB-label pairs (b5)")
    p.add_argument("--x-dir", required=True, help="leftImg8bit frames")
    p.add_argument("--y-dir", required=True, help="gtFine *_gtFine_color.png dir")
    p.add_argument("--out", required=True)
    p.add_argument("--crop", type=_hw, default=(1024, 2048))
    p.add_argument("--max-samples", type=int, default=-1)
    p.set_defaults(fn=_cook_cityscapes_rgb)

    p = sub.add_parser("aria-summary", help="summarize a cooked Aria ADT cache")
    p.add_argument("--cache-dir", required=True)
    p.add_argument("--out", default=None, help="output jsonl (default <cache>/smry.json)")
    p.set_defaults(fn=_aria_summary)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
