"""Grid and fold helpers in numpy (counterpart of
``fovealseg_tpu/utils/torch_tools.py``, a numpy copy of the DynamicFocus
``utility/torch_tools.py`` surface): padding, ``cross_fold`` /
``cross_unfold``, majority pooling, alpha channels, kernel swaps and the
Gaussian focus map. The gaze maps of the model are in
``fovealseg_torch/core/gaze.py``.
"""

from __future__ import annotations

import numpy as np


def get_padding(h: int, w: int, multiple: int) -> tuple[int, int, int, int]:
    """(left, right, top, bottom) padding to round (h, w) up to a multiple."""
    th = ((h - 1) // multiple + 1) * multiple
    tw = ((w - 1) // multiple + 1) * multiple
    dh, dw = th - h, tw - w
    return dw // 2, dw - dw // 2, dh // 2, dh - dh // 2


def cross_unfold(x: np.ndarray, size_step: int) -> np.ndarray:
    """[..., H, W] -> [..., H/k, W/k, k, k] non-overlapping tiling."""
    k = size_step
    *lead, h, w = x.shape
    assert h % k == 0 and w % k == 0
    y = x.reshape(*lead, h // k, k, w // k, k)
    return np.moveaxis(y, -3, -2)


def cross_fold(x: np.ndarray) -> np.ndarray:
    """Inverse of cross_unfold: [..., Hs, Ws, k, k] -> [..., Hs*k, Ws*k]."""
    *lead, hs, ws, k, k2 = x.shape
    assert k == k2
    y = np.moveaxis(x, -2, -3)
    return y.reshape(*lead, hs * k, ws * k)


def interpolate_int(x: np.ndarray, degree: int = 1) -> np.ndarray:
    """Majority-vote integer downsampling by 2**degree
    (torch_tools.interpolate_int:54-62). x: [..., H, W] int."""
    k = 2**degree
    tiles = cross_unfold(x, k)
    flat = tiles.reshape(*tiles.shape[:-2], k * k)
    max_v = int(flat.max()) + 1
    counts = np.apply_along_axis(lambda v: np.bincount(v, minlength=max_v), -1, flat)
    return counts.argmax(axis=-1).astype(x.dtype)


def get_padding_to_canvas(h: int, w: int, hc: int, wc: int) -> tuple[int, int, int, int]:
    """(left, right, top, bottom) centered padding onto an (hc, wc) canvas
    (reference signature, torch_tools.get_padding:6-11)."""
    pad_left = (wc - w) // 2
    pad_right = wc - w - pad_left
    pad_top = (hc - h) // 2
    pad_bottom = hc - h - pad_top
    return pad_left, pad_right, pad_top, pad_bottom


def add_alpha(img: np.ndarray, alpha: np.ndarray | None = None) -> np.ndarray:
    """Append an alpha channel to [..., C, H, W] (torch_tools.add_alpha:14-34).

    alpha defaults to all-ones; when given it must be broadcastable to
    [..., H, W].
    """
    *lead, c, h, w = img.shape
    out = np.zeros((*lead, c + 1, h, w), np.float32)
    out[..., :-1, :, :] = img
    if alpha is None:
        out[..., -1, :, :] = 1.0
    else:
        assert alpha.shape[-2:] == (h, w), "alpha mask must have shape HxW"
        out[..., -1, :, :] = alpha
    return out


def kernel_swap(x: np.ndarray) -> np.ndarray:
    """[..., H, W, K, K] -> [..., K, K, H, W] (torch_tools.kernel_swap:37-39)."""
    y = np.swapaxes(x, -4, -2)
    return np.swapaxes(y, -3, -1)


def gaussian_function(x, mean: float = 0.0, std: float = 1.0):
    """Normalized Gaussian pdf (torch_tools.gaussian_function:72-80)."""
    x = np.asarray(x, np.float32)
    coeff = 1.0 / (std * np.sqrt(2.0 * np.pi))
    return (coeff * np.exp(-0.5 * ((x - mean) / std) ** 2)).astype(np.float32)


def gen_focus_gaussian_hw(idx_h: float, idx_w: float, canvas_h: int, canvas_w: int,
                          mean: float = 0.0, std: float = 512.0) -> np.ndarray:
    """Max-normalized Gaussian of gaze distance over an (H, W) canvas
    (torch_tools.gen_focus_Gaussian_HxW:83-91)."""
    rr = np.arange(canvas_h, dtype=np.float32)[:, None]
    cc = np.arange(canvas_w, dtype=np.float32)[None, :]
    dist = np.sqrt((rr - idx_h) ** 2 + (cc - idx_w) ** 2)
    v = gaussian_function(dist, mean=mean, std=std)
    return v / v.max()


def str_tensor_shape(arr) -> str:
    """'AxBxC' shape string (torch_tools.str_tensor_shape:94-95)."""
    return "x".join(map(str, np.asarray(arr).shape))
