"""TensorBoard writer of the eval visualisation (counterpart of
``fovealseg_tpu/utils/observe.py::SummaryWriter``).

``add_scalar`` / ``add_image`` go to ``torch.utils.tensorboard`` when it can
be imported; otherwise, as in the JAX package, scalars go to
``scalars.jsonl`` and images to PNG files in the log directory.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class SummaryWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter as TBW

            self._tb = TBW(log_dir)
        except ImportError:
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        else:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                          "step": int(step), "ts": time.time()}) + "\n")
            self._jsonl.flush()

    def add_image(self, tag: str, img_hwc01: np.ndarray, step: int) -> None:
        if self._tb is not None:
            import torch

            self._tb.add_image(tag, torch.from_numpy(
                np.asarray(img_hwc01, np.float32)).permute(2, 0, 1), step)
        else:
            from fovealseg_torch.utils.visuals import save_rgb01

            save_rgb01(img_hwc01, os.path.join(self.log_dir, f"{tag.replace('/', '_')}_{step}.png"))

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()
