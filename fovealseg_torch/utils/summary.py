"""Parameter summaries (counterpart of ``fovealseg_tpu/utils/summary.py``)."""

from __future__ import annotations

import torch


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def summarize(model: torch.nn.Module) -> str:
    """One line per sub-network (its parameter count and f32 MB), the total,
    and the BN statistics' count."""
    lines = ["=" * 52, f"{'subtree':<28}{'params':>12}{'MB (f32)':>10}", "-" * 52]
    total = 0
    for name, sub in sorted(model.named_children()):
        n = count_params(sub)
        total += n
        lines.append(f"{name:<28}{n:>12,}{n * 4 / 2**20:>10.2f}")
    lines.append("-" * 52)
    lines.append(f"{'total':<28}{total:>12,}{total * 4 / 2**20:>10.2f}")
    stats = sum(b.numel() for n, b in model.named_buffers() if n.endswith(("running_mean",
                                                                          "running_var")))
    if stats:
        lines.append(f"{'batch_stats':<28}{stats:>12,}")
    lines.append("=" * 52)
    return "\n".join(lines)
