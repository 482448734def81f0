"""Visualization: confusion heatmap, sample-image grids, training curves
and the sweep's cross-fold curve (the JAX package's ``utils/viz.py``).

Figures are written to PNG files, so they work headless.
:func:`plot_confusion_matrix` and :func:`plot_image_grid`, the final
run's artifacts, are drawn with PIL (a cell grid with counts and class
labels; tiles with their titles), so they are the same on every machine
and need neither matplotlib nor seaborn.  :func:`plot_history` and
:func:`plot_epoch_mean_std` draw with matplotlib (Agg backend), imported
when such a figure is drawn, not with this module.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# matplotlib's "Blues" colormap at 0, 0.5 and 1
_BLUES = np.array([[247, 251, 255], [107, 174, 214], [8, 48, 107]],
                  np.float64)


def pyplot():
    """matplotlib's pyplot on the Agg backend, imported when a figure is
    drawn."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_confusion_matrix(cm: np.ndarray, class_names: Sequence[str],
                          path: str,
                          title: str = "Confusion Matrix") -> str:
    """Counts heatmap (rows true, columns predicted) with every cell
    annotated, on matplotlib's "Blues" scale."""
    from PIL import Image, ImageDraw

    cm = np.asarray(cm)
    font, small = _font(16), _font(13)
    probe = ImageDraw.Draw(Image.new("RGB", (1, 1)))
    label_w = max([_text_size(probe, str(c), small)[0]
                   for c in class_names] + [1])
    n = len(class_names)
    cell = max(44, _text_size(probe, str(int(cm.max(initial=0))),
                              small)[0] + 12)
    pad, title_h, axis_h = 16, 36, 24
    left = pad + axis_h + label_w + 8
    top = pad + title_h
    width = left + n * cell + pad
    height = top + n * cell + 8 + label_w + axis_h + pad
    img = Image.new("RGB", (width, height), "white")
    draw = ImageDraw.Draw(img)
    tw, _ = _text_size(draw, title, font)
    draw.text(((width - tw) // 2, pad), title, fill="black", font=font)
    peak = max(int(cm.max(initial=0)), 1)
    for i in range(n):
        for j in range(n):
            v = int(cm[i, j])
            frac = v / peak
            x0, y0 = left + j * cell, top + i * cell
            draw.rectangle([x0, y0, x0 + cell - 1, y0 + cell - 1],
                           fill=_blues(frac), outline=(200, 200, 200))
            text = str(v)
            w, h = _text_size(draw, text, small)
            draw.text((x0 + (cell - w) // 2, y0 + (cell - h) // 2), text,
                      fill="white" if frac > 0.5 else "black", font=small)
    for i, name in enumerate(class_names):
        w, h = _text_size(draw, str(name), small)
        draw.text((left - 8 - w, top + i * cell + (cell - h) // 2),
                  str(name), fill="black", font=small)
        # column labels, turned 90 degrees
        tile = _rotated_label(str(name), small)
        img.paste(tile, (left + i * cell + (cell - tile.width) // 2,
                         top + n * cell + 8))
    w, _ = _text_size(draw, "Predicted", font)
    draw.text((left + (n * cell - w) // 2, height - pad - axis_h + 4),
              "Predicted", fill="black", font=font)
    ylab = _rotated_label("True", font)
    img.paste(ylab, (pad, top + (n * cell - ylab.height) // 2))
    img.save(path, format="PNG")
    return path


def plot_image_grid(images: Sequence[np.ndarray], titles: Sequence[str],
                    path: str, ncols: int = 5,
                    suptitle: Optional[str] = None) -> str:
    """uint8 HWC images in a grid with per-image titles; tiles larger than
    256 pixels are shrunk to fit."""
    from PIL import Image, ImageDraw

    n = len(images)
    if n == 0:
        return path
    ncols = min(ncols, n)
    nrows = -(-n // ncols)
    font, big = _font(13), _font(16)
    probe = ImageDraw.Draw(Image.new("RGB", (1, 1)))
    tiles = [Image.fromarray(np.asarray(im).astype(np.uint8)) for im in images]
    side = min(max(max(t.width, t.height) for t in tiles), 256)
    title_h = max([_text_size(probe, str(t), font)[1] for t in titles]
                  + [0]) + 10
    pad = 12
    sup_h = _text_size(probe, suptitle, big)[1] + 2 * pad if suptitle else 0
    cell_w, cell_h = side + pad, side + title_h + pad
    width = pad + ncols * cell_w
    height = sup_h + pad + nrows * cell_h
    img = Image.new("RGB", (width, height), "white")
    draw = ImageDraw.Draw(img)
    if suptitle:
        w, _ = _text_size(draw, suptitle, big)
        draw.text(((width - w) // 2, pad), suptitle, fill="black", font=big)
    for k, (tile, title) in enumerate(zip(tiles, titles)):
        r, c = divmod(k, ncols)
        x0 = pad + c * cell_w
        y0 = sup_h + pad + r * cell_h
        w, _ = _text_size(draw, str(title), font)
        draw.multiline_text((x0 + max((side - w) // 2, 0), y0), str(title),
                            fill="black", font=font, align="center")
        if max(tile.width, tile.height) > side:
            tile.thumbnail((side, side), Image.BILINEAR)
        img.paste(tile, (x0 + (side - tile.width) // 2,
                         y0 + title_h + (side - tile.height) // 2))
    img.save(path, format="PNG")
    return path


def plot_history(history: Dict[str, List[float]], path: str) -> str:
    """Train/val loss and accuracy curves.  Series may be missing or of
    unequal length (a run killed mid-epoch, a no-validation final run):
    each gets its own epoch axis."""
    plt = pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4.5))

    def _plot(ax, key, label):
        ys = history.get(key) or []
        if ys:
            ax.plot(range(1, len(ys) + 1), ys, label=label)
        return bool(ys)

    any1 = _plot(ax1, "train_loss", "train") | _plot(ax1, "val_loss", "val")
    ax1.set_xlabel("epoch")
    ax1.set_ylabel("loss")
    if any1:
        ax1.legend()
    ax1.set_title("Loss")
    any2 = _plot(ax2, "train_acc", "train") | _plot(ax2, "val_acc", "val")
    ax2.set_xlabel("epoch")
    ax2.set_ylabel("accuracy (%)")
    if any2:
        ax2.legend()
    ax2.set_title("Accuracy")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_epoch_mean_std(epochs: Sequence[int], means: Sequence[float],
                        stds: Sequence[float], path: str,
                        title: str = "Cross-fold validation accuracy"
                        ) -> str:
    """Mean accuracy per epoch with a +-std band."""
    plt = pyplot()
    means = np.asarray(means)
    stds = np.asarray(stds)
    plt.figure(figsize=(8, 5))
    plt.plot(epochs, means, marker="o")
    plt.fill_between(epochs, means - stds, means + stds, alpha=0.25)
    plt.xlabel("epoch")
    plt.ylabel("val acc (%)")
    plt.title(title)
    plt.tight_layout()
    plt.savefig(path)
    plt.close()
    return path


# -- PIL helpers -----------------------------------------------------------

def _font(size: int):
    from PIL import ImageFont

    return ImageFont.load_default(size=size)


def _text_size(draw, text: str, font) -> tuple:
    box = draw.multiline_textbbox((0, 0), text, font=font)
    return box[2] - box[0], box[3] - box[1]


def _rotated_label(text: str, font):
    """``text`` on a white tile that fits it, turned 90 degrees."""
    from PIL import Image, ImageDraw

    box = ImageDraw.Draw(Image.new("RGB", (1, 1))).textbbox((0, 0), text,
                                                            font=font)
    tile = Image.new("RGB", (box[2] - box[0] + 2, box[3] - box[1] + 2),
                     "white")
    ImageDraw.Draw(tile).text((1 - box[0], 1 - box[1]), text, fill="black",
                              font=font)
    return tile.rotate(90, expand=True)


def _blues(frac: float) -> tuple:
    x = 2.0 * frac
    lo = min(int(x), 1)
    return tuple(int(c) for c in np.rint(
        _BLUES[lo] + (_BLUES[lo + 1] - _BLUES[lo]) * (x - lo)))
