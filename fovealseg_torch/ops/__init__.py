"""The port's hand-written kernels as registered operators.

Importing this package registers ``torch.ops.fovealseg.*`` (the four jump
floods of ``jfa.py`` and the row gather and its backward of ``gather.py``),
which is all that a process needs to load and run a program that
``fovealseg_torch.cli.export`` wrote::

    import torch
    import fovealseg_torch.ops  # noqa: F401
    labels = torch.export.load("model.pt2").module()(images, gaze)
"""

from fovealseg_torch.ops import gather, jfa  # noqa: F401
