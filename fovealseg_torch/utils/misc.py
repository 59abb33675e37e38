"""Small reference-utils work-alikes (counterpart of
``fovealseg_tpu/utils/misc.py``, a numpy copy): ``parse_devices`` (the
reference's --gpus grammar), ``find_recursive``, ``accuracy_ltds`` and
``preprocessing_accuracy``.
"""

from __future__ import annotations

import fnmatch
import os
import re

import numpy as np


class NotSupportedCliException(Exception):
    pass


def _range(prefix: str, groups) -> list[str]:
    start, end = map(int, groups)
    if start > end:
        start, end = end, start
    return [f"{prefix}{i}" for i in range(start, end + 1)]


_DEVICE_PATTERNS = [
    (re.compile(r"^gpu(\d+)$"), lambda g: [f"gpu{g[0]}"]),
    (re.compile(r"^(\d+)$"), lambda g: [f"gpu{g[0]}"]),
    (re.compile(r"^gpu(\d+)-(?:gpu)?(\d+)$"), lambda g: _range("gpu", g)),
    (re.compile(r"^(\d+)-(\d+)$"), lambda g: _range("gpu", g)),
]


def parse_devices(input_devices: str) -> list[str]:
    """'0-1' / 'gpu0,gpu2' / '0,1,3' -> ['gpu0', ...] (utils.py:341-361).

    The grammar is the reference's; the port's CLIs parse ``--gpus`` into
    CUDA ordinals themselves (``cli/train.py::parse_devices``).
    """
    out: list[str] = []
    for d in input_devices.split(","):
        for regex, expand in _DEVICE_PATTERNS:
            m = regex.match(d.lower().strip())
            if m:
                for x in expand(m.groups()):
                    if x not in out:
                        out.append(x)
                break
        else:
            raise NotSupportedCliException(f'Can not recognize device: "{d}"')
    return out


def find_recursive(root_dir: str, ext: str = ".jpg") -> list[str]:
    """All files under root_dir with the extension (utils.py:118-124)."""
    files = []
    for root, _, filenames in os.walk(root_dir):
        for filename in fnmatch.filter(filenames, "*" + ext):
            files.append(os.path.join(root, filename))
    return files


def accuracy_ltds(preds, label):
    """(accuracy over label>=0 pixels, valid count) — utils.py:224-229."""
    preds = np.asarray(preds)
    label = np.asarray(label)
    valid = label >= 0
    acc_sum = (valid * (preds == label)).sum()
    valid_sum = valid.sum()
    return float(acc_sum) / (valid_sum + 1e-10), int(valid_sum)


def preprocessing_accuracy(label_true, label_pred, n_class: int = 2):
    """Flatten + mask labels for metric computation (utils.py:11-23):
    binarize predictions at 0.5 when n_class==2, keep pixels with
    0 <= label < n_class and label != 8 (the reference's hard-coded
    ignore id)."""
    label_pred = np.asarray(label_pred)
    if n_class == 2:
        label_pred = np.where(label_pred > 0.5, 1, 0)
    label_pred = np.asarray(label_pred, dtype="int8")
    label_true = np.asarray(label_true, dtype="int8")
    mask = (label_true >= 0) & (label_true < n_class) & (label_true != 8)
    return label_true[mask].astype(int), label_pred[mask].astype(int)
