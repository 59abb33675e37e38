"""Dynamic task sizing, ``TRAIN.dynamic_task_input`` (counterpart of
``fovealseg_tpu/models/bucketed.py``).

The reference's ``re_initialise`` sets the module's grid geometry from each
input's size, for datasets whose frames differ in size. The JAX package
pads every input up to a bucket of 32 pixels and keeps one module per
bucket, so that XLA compiles once per bucket; the port needs no such pad
and derives the geometry from the raw size, as the reference does.
:class:`BucketedDeform` keeps one set of weights (one
``DeformSegmentation``) and, per input size, a view of it that carries that
size's task and saliency geometry.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from fovealseg_torch.models.deform_module import DeformSegmentation


def derive_task_size(this_hw: tuple[int, int],
                     dynamic_task_input: tuple[int, int]) -> tuple[int, int]:
    """``re_initialise``'s task size: the input scaled down by whichever of
    the short- and long-edge ratios gives the smaller task area."""
    short, long_ = min(this_hw), max(this_hw)
    r1 = max(short // min(dynamic_task_input), 1)
    r2 = max(long_ // max(dynamic_task_input), 1)
    s1 = (this_hw[0] // r1, this_hw[1] // r1)
    s2 = (this_hw[0] // r2, this_hw[1] // r2)
    return s1 if s1[0] * s1[1] < s2[0] * s2[1] else s2


class BucketedDeform:
    """One ``DeformSegmentation``'s weights served at any input size: for an
    [B, H, W, 3] input, :meth:`module_for` gives a view of ``model`` (the
    same sub-networks, no copy of the weights) whose ``task_hw``,
    ``task_hw_infer`` and ``saliency_hw`` are derived from (H, W), built
    once per size. :meth:`infer` runs that view's ``infer``; a training
    forward calls ``module_for(x.shape[1:3])(x, focus_point, train=True,
    ...)``."""

    @classmethod
    def from_cfg(cls, cfg, model: DeformSegmentation) -> "BucketedDeform":
        """``TRAIN.dynamic_task_input`` sizes the task and
        ``TRAIN.dynamic_saliency_relative_size`` scales the saliency input
        relative to it."""
        return cls(model, tuple(cfg.TRAIN.dynamic_task_input),
                   float(cfg.TRAIN.dynamic_saliency_relative_size))

    def __init__(self, model: DeformSegmentation, dynamic_task_input: tuple[int, int],
                 saliency_relative: float = 1.0):
        self.model = model
        self.dynamic_task_input = tuple(dynamic_task_input)
        self.saliency_relative = saliency_relative
        self._views: dict[tuple[int, int], DeformSegmentation] = {}

    def module_for(self, input_hw: tuple[int, int]) -> DeformSegmentation:
        hw = (int(input_hw[0]), int(input_hw[1]))
        view = self._views.get(hw)
        if view is None:
            task = derive_task_size(hw, self.dynamic_task_input)
            sal = (int(task[0] * self.saliency_relative), int(task[1] * self.saliency_relative))
            # a shallow copy shares the sub-networks (and their weights)
            view = copy.copy(self.model)
            view.config = dataclasses.replace(self.model.config, task_hw=task,
                                              task_hw_infer=task, saliency_hw=sal)
            self._views[hw] = view
        view.training = self.model.training  # the shared sub-networks' mode
        return view

    def infer(self, x: torch.Tensor, focus_point: torch.Tensor, **kwargs):
        return self.module_for(x.shape[1:3]).infer(x, focus_point, **kwargs)
