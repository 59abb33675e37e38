"""PyTorch + CUDA port of fovealseg for NVIDIA Hopper (H100).

The package mirrors ``fovealseg_tpu``'s tree (``configs``, ``core``, ``ops``,
``models``, ``train``, ``cli``) and keeps its public layouts (images
``[B,H,W,3]``, grids ``[B,h,w,2]`` as (x, y), logits ``[B,h,w,C]``, labels
``[B,Hs,Ws]`` int32) so each function can be held against its JAX
counterpart. It imports neither JAX nor the JAX package.

Entry points run on the card unless the caller asks for the CPU:
:func:`resolve_device` turns ``None`` into ``cuda`` and raises when no card
is present, so nothing carries on quietly on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fovealseg_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly to run on the host")
    return dev
