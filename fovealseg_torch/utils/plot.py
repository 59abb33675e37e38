"""Matplotlib figure helpers (counterpart of ``fovealseg_tpu/utils/plot.py``;
the DynamicFocus ``utility/plot_tools.py`` surface): ``plt_imgshow``,
``plt_multi_imgshow`` and ``plt_show``. Arrays are numpy or tensors (any
array-like); [C, H, W] inputs are shown as [H, W, C], and one-channel or 2-D
images get a colorbar. Matplotlib is imported inside the functions, with
the ``Agg`` backend, so the module imports where matplotlib is absent and
draws on a host without a display.
"""

from __future__ import annotations

import numpy as np

__all__ = ["plt_imgshow", "plt_multi_imgshow", "plt_show"]


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plt_imgshow(img, title: str = "", ax=None):
    """Show one image on ax (created if None); returns the AxesImage."""
    fig = None
    if ax is None:
        fig, ax = _plt().subplots(figsize=(8, 6))

    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] in (1, 3, 4) and img.shape[0] < img.shape[-1]:
        img = np.transpose(img, (1, 2, 0))
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]

    cax = ax.imshow(img)
    if title:
        ax.set_title(title)
    if img.ndim == 2 and fig is not None:
        fig.colorbar(cax, ax=ax)
    ax.grid(False)
    return cax


def plt_multi_imgshow(imgs: list, titles: list | None = None,
                      row_col: tuple[int, int] = (1, 1)):
    """A grid of images through :func:`plt_imgshow`; None entries leave
    their cell hidden. Returns the figure."""
    rows, cols = row_col
    fig, axes = _plt().subplots(rows, cols, figsize=(cols * 8, rows * 6))
    axes = axes.flatten() if isinstance(axes, np.ndarray) else [axes]
    for ax in axes:
        ax.grid(False)
        ax.set_visible(False)
    if titles is None:
        titles = [str(i) for i in range(len(imgs))]
    for i, (img, title) in enumerate(zip(imgs, titles)):
        if img is not None:
            axes[i].set_visible(True)
            cax = plt_imgshow(img, title, axes[i])
            arr = np.asarray(img)
            # a colorbar per one-channel cell, as the reference's grid loop draws
            if arr.ndim == 2 or (arr.ndim == 3 and 1 in (arr.shape[0], arr.shape[2])):
                fig.colorbar(cax, ax=axes[i])
    fig.tight_layout()
    return fig


def plt_show(block: bool = True) -> None:
    _plt().show(block=block)
