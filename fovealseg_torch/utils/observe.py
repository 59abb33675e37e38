"""Observability: logger, TensorBoard writer, memory introspection, IO
(counterpart of ``fovealseg_tpu/utils/observe.py``).

* :func:`setup_logger`: stdout (and file) logger in the reference's format.
* :class:`SummaryWriter`: ``add_scalar`` / ``add_image`` go to
  ``torch.utils.tensorboard`` when it can be imported; otherwise, as in the
  JAX package, scalars go to ``scalars.jsonl`` and images to PNG files in
  the log directory.
* :func:`device_memory_stats`, :func:`try_device`, :class:`RAM`, and the
  model helpers (:func:`calc_model_memsize`, :func:`show_model_info`,
  :func:`init_weights_zero`, :func:`init_weights_random`) over an
  ``nn.Module``'s named parameters, where the JAX package takes a flax
  parameter tree.
* The reference's IO helpers: images (PIL), json, jsonl, pickle, text, and
  tensors as ``.npy``.

pandas and matplotlib are imported inside the functions that need them.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import sys
import time
from typing import Any

import numpy as np


def setup_logger(distributed_rank: int = 0, filename: str | None = None) -> logging.Logger:
    """The ``fovealseg`` logger on stdout (and ``filename``) in the
    reference's format; ranks other than 0 get no handler."""
    logger = logging.getLogger("fovealseg")
    logger.setLevel(logging.INFO)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("[%(asctime)s %(levelname)s %(filename)s:%(lineno)d] %(message)s")
    if distributed_rank == 0:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if filename:
            fh = logging.FileHandler(filename)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


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


def device_memory_stats() -> list[dict]:
    """Per CUDA device: the bytes its tensors hold and its total memory. On
    a host without a card, an empty list."""
    import torch

    if not torch.cuda.is_available():
        return []
    return [{"device": f"cuda:{i}",
             "bytes_in_use": torch.cuda.memory_allocated(i),
             "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
            for i in range(torch.cuda.device_count())]


def try_device(kind: str = "cuda"):
    """The first device of ``kind``; raises when there is none (the port
    falls back to the CPU only when the caller asks for it)."""
    import torch

    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"unknown device kind {kind!r} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass kind='cpu' to run on the host")
    return torch.device("cuda", 0)


class RAM:
    """An attribute bag whose ``gc`` drops every attribute."""

    def gc(self):
        for k in list(self.__dict__):
            delattr(self, k)


# -- IO helpers ---------------------------------------------------------------

def load_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def save_image(img01: np.ndarray, path: str) -> None:
    from fovealseg_torch.utils.visuals import save_rgb01

    save_rgb01(img01, path)


def save_json(obj: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def save_pickle(obj: Any, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_tensor(arr, path: str) -> None:
    """A tensor or array as ``.npy`` (a tensor through the host)."""
    if hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    np.save(path, np.asarray(arr))


def load_tensor(path: str) -> np.ndarray:
    return np.load(path)


def save_jsonl(data, path: str) -> None:
    """One JSON object per line."""
    with open(path, "w", encoding="utf-8") as f:
        for entry in data:
            f.write(json.dumps(entry, ensure_ascii=False) + "\n")


def read_jsonl(path: str) -> list:
    with open(path, encoding="utf-8") as f:
        return [json.loads(line.strip()) for line in f if line.strip()]


def save_text(data: str, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(data)


def read_text(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read()


def date2datetime(d):
    """A date -> its midnight datetime."""
    import datetime as _dt

    return _dt.datetime.combine(d, _dt.time())


def get_args_kwargs(*args, **kwargs):
    return args, kwargs


def get_dctns_cols_by_df(df):
    """DataFrame -> (row dicts, column list)."""
    cols = df.columns.values.tolist()
    dctns = [dict(zip(cols, row)) for row in df.values.tolist()]
    return dctns, cols


def get_df_by_dctns_cols(dctns, cols):
    """(row dicts, column list) -> DataFrame."""
    import pandas as pd

    return pd.DataFrame(dctns, columns=cols)


def pbox(box) -> None:
    """Print an iterable of lines."""
    for line in box:
        print(line)


def xprint(*args, flush: bool = True, **kwargs) -> None:
    """Timestamped print."""
    print(time.strftime("[%H:%M:%S]"), *args, flush=flush, **kwargs)


# -- model and memory introspection -------------------------------------------

def byte2mb(bt: float) -> float:
    return round(bt / (1024**2), 3)


_UNIT_DIV = {"KB": 1024, "MB": 1024**2, "GB": 1024**3}


def calc_tensor_memsize(arr, unit: str = "MB") -> float:
    """A tensor's (or array's) size in KB, MB or GB."""
    if unit not in _UNIT_DIV:
        raise ValueError("Invalid unit. Please choose from 'KB', 'MB', or 'GB'.")
    if hasattr(arr, "element_size"):
        return arr.numel() * arr.element_size() / _UNIT_DIV[unit]
    return arr.size * arr.dtype.itemsize / _UNIT_DIV[unit]


def calc_model_memsize(model, unit: str = "MB", show: bool = True,
                       label: str = "the model") -> float:
    """The summed size of a module's parameters."""
    total = sum(calc_tensor_memsize(p, unit) for p in model.parameters())
    if show:
        print(f"Total memory size of {label} in {unit}: {total:.4f} {unit}")
    return total


def show_model_info(model, show_details: bool = True):
    """A table of the module's named parameters -> (total elements, total
    MB)."""
    import pandas as pd

    named = list(model.named_parameters())
    table = [[name, p.numel(), round(p.numel() * p.element_size() / 1024, 2)]
             for name, p in named]
    df = pd.DataFrame(table, columns=["Modules", "Parameters", "Mem (KB)"])
    if show_details:
        with pd.option_context("display.max_rows", None, "display.max_columns", None):
            print(df)
    total_ele = int(sum(p.numel() for _, p in named))
    total_mem = round(sum(p.numel() * p.element_size() for _, p in named) / 1024**2, 4)
    print(f"Total Trainable : {total_ele} ele , {total_mem} MB\n")
    return total_ele, total_mem


def init_weights_zero(model):
    """Zero every parameter of ``model`` in place; returns it."""
    import torch

    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    return model


def init_weights_random(model, generator):
    """Re-initialise ``model``'s parameters in place from ``generator``
    (a ``torch.Generator`` on the parameters' device), as the JAX
    package's ``init_weights_random`` does over a parameter tree: conv and
    linear weights ``xavier_normal_`` (the fans include the receptive field),
    norm-layer weights (1-D ``weight``s, flax's ``scale``) N(1, 0.02), biases
    0, anything else N(0, 1). Returns it."""
    import torch

    def normal(p):
        return torch.randn(p.shape, generator=generator, device=p.device, dtype=p.dtype)

    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and p.dim() == 1:
                p.copy_(1.0 + 0.02 * normal(p))
            elif leaf == "bias":
                p.zero_()
            elif p.dim() >= 2:
                rf = int(np.prod(p.shape[2:])) if p.dim() > 2 else 1
                fan_in, fan_out = int(p.shape[1]) * rf, int(p.shape[0]) * rf
                p.copy_(normal(p) * float(np.sqrt(2.0 / (fan_in + fan_out))))
            else:
                p.copy_(normal(p))
    return model
