"""The ``fovealseg`` operator namespace: each hand-written kernel's wrapper
calls a registered operator, ``torch.ops.fovealseg.<name>``, with a CPU
kernel (the plain PyTorch version), a CUDA kernel (the launch) and a fake
kernel (the output's shape and dtype, for a trace such as ``torch.export``,
which records the operator and nothing inside it).

The operators are defined with ``torch.library.Library`` rather than
``torch.library.custom_op``: the latter wraps every call in Python
autograd and view handling, host time that the row gather's ~10-40 us
launches at C <= 3 would pay. The gradient of the row gather is
``gather.RowGather``'s, which calls the backward's operator.
"""

from __future__ import annotations

import torch

_LIB = torch.library.Library("fovealseg", "FRAGMENT")


def register(schema: str, cpu, cuda, fake):
    """Define ``fovealseg::<schema>`` with its three kernels; returns the
    operator's overload."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"fovealseg::{name}", fake, lib=_LIB)
    return getattr(torch.ops.fovealseg, name).default
