"""Display helpers (twin of ``zuds_tpu/plotting.py``). Each imports
matplotlib when it is called, as the reference does: without matplotlib
they raise ``ImportError``."""
from __future__ import annotations

import numpy as np

from .constants import CMAP_RANDOM_SEED

__all__ = ['discrete_cmap', 'show_images', 'plot_triplet']


def discrete_cmap(ncolors):
    """Random-colour discrete colormap for segmentation maps, colour 0
    black (plotting.py:11-18)."""
    from matplotlib import colors
    rng = np.random.default_rng(CMAP_RANDOM_SEED)
    cols = rng.uniform(0, 1, size=(max(ncolors, 1), 3))
    cols[0] = 0.0
    return colors.ListedColormap(cols)


def show_images(images, catalog=None, titles=None, figsize=None, ds9=False):
    """A grid of images, three a row, with the catalog's rows drawn as
    ellipses (lime on GOODCUT rows, red otherwise) (plotting.py:21-62).
    Returns the figure."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import Ellipse

    if not isinstance(images, (list, tuple)):
        images = [images]
    n = len(images)
    ncol = min(n, 3)
    nrow = (n + ncol - 1) // ncol
    if figsize is None:
        figsize = (4 * ncol, 4 * nrow)
    fig, axes = plt.subplots(nrow, ncol, figsize=figsize, squeeze=False)
    for i, image in enumerate(images):
        ax = axes[i // ncol][i % ncol]
        vmin, vmax = image.cmap_limits()
        ax.imshow(np.asarray(image.data), vmin=vmin, vmax=vmax,
                  cmap=image.cmap(), norm=image.cmap_norm(),
                  interpolation='none', origin='lower')
        if titles is not None:
            ax.set_title(titles[i])
        if catalog is not None:
            data = catalog.data if hasattr(catalog, 'data') else catalog
            for row in data:
                color = 'lime' if row['GOODCUT'] == 1 else 'red'
                ax.add_patch(Ellipse(
                    (row['X_IMAGE'] - 1, row['Y_IMAGE'] - 1),
                    width=6 * row['A_IMAGE'], height=6 * row['B_IMAGE'],
                    angle=row['THETA_IMAGE'], fill=False, color=color,
                    lw=0.8))
    for j in range(n, nrow * ncol):
        axes[j // ncol][j % ncol].axis('off')
    fig.tight_layout()
    return fig


def plot_triplet(triplet, figsize=(9, 3)):
    """A (63, 63, 3) new/ref/sub triplet side by side (plotting.py:65-74)."""
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(1, 3, figsize=figsize)
    for i, name in enumerate(['new', 'ref', 'sub']):
        axes[i].imshow(triplet[:, :, i], cmap='gray', origin='lower')
        axes[i].set_title(name)
        axes[i].axis('off')
    fig.tight_layout()
    return fig
