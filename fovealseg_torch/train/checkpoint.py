"""Carrying weights into the port (counterpart of the torch import/export in
``fovealseg_tpu/train/checkpoint.py``).

* :func:`from_jax_variables` maps the JAX package's parameter trees, given as
  nested dicts of numpy arrays (``flax.traverse_util`` style), to a
  ``DeformSegmentation`` state dict: conv kernels HWIO -> OIHW, Dense kernels
  transposed, BN scale -> weight, mean/var -> running_mean/running_var, under
  the four subtrees ``localization``, ``net_compress``, ``encoder``,
  ``decoder``. It is the port's own copy of the mapping in
  ``export_torch_state_dict``.
* :func:`load_torch_checkpoint` loads the reference's 4-file set
  ``{saliency,compress,encoder,decoder}_epoch_N.pth`` into a model.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import numpy as np
import torch

# file kind -> DeformSegmentation submodule
SUBMODULE_OF_FILE = {
    "saliency": "localization",
    "compress": "net_compress",
    "encoder": "encoder",
    "decoder": "decoder",
}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_variables(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """JAX (params, batch_stats) numpy trees -> ``DeformSegmentation`` state dict."""
    out: dict[str, torch.Tensor] = {}
    tops = set(SUBMODULE_OF_FILE.values())

    def put(key, arr):
        out[key] = torch.from_numpy(np.array(arr, copy=True, order="C"))

    for path, arr in _flatten(params):
        if path[0] not in tops:
            continue
        mod, leaf = ".".join(path[:-1]), path[-1]
        arr = np.asarray(arr, np.float32)
        if leaf == "kernel" and arr.ndim == 4:
            put(f"{mod}.weight", arr.transpose(3, 2, 0, 1))  # HWIO -> OIHW
        elif leaf == "kernel" and arr.ndim == 2:
            put(f"{mod}.weight", arr.T)
        elif leaf == "scale":
            put(f"{mod}.weight", arr)
        elif leaf == "bias":
            put(f"{mod}.bias", arr)
        else:
            raise KeyError(f"no torch mapping for JAX parameter {'/'.join(path)}")
    for path, arr in _flatten(batch_stats):
        if path[0] not in tops:
            continue
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf not in ("mean", "var"):
            raise KeyError(f"no torch mapping for JAX batch statistic {'/'.join(path)}")
        put(f"{mod}.running_{leaf}", np.asarray(arr, np.float32))
        out.setdefault(f"{mod}.num_batches_tracked", torch.tensor(0, dtype=torch.int64))
    return out


def load_torch_checkpoint(model: torch.nn.Module, ckpt_dir: str, epoch="last") -> None:
    """Load ``{saliency,compress,encoder,decoder}_epoch_{epoch}.pth`` into the
    four submodules of ``model`` (each strictly). A missing file raises:
    a sub-network left at its random init would serve quietly wrong masks."""
    for kind, sub in SUBMODULE_OF_FILE.items():
        path = os.path.join(ckpt_dir, f"{kind}_epoch_{epoch}.pth")
        if not os.path.exists(path):
            raise FileNotFoundError(f"checkpoint file missing: {path}")
        sd = torch.load(path, map_location="cpu", weights_only=True)
        getattr(model, sub).load_state_dict(sd, strict=True)
