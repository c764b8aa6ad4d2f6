"""Factor-map plotting (utilities.py:421-448 equivalent; a copy of
``gpzoo_tpu/data/plotting.py``).

Optional matplotlib dependency, imported at call time.
"""

from __future__ import annotations

import numpy as np


def plot_factors(factors, coords, moran_idx=None, size=7, alpha=0.8, s=0.1,
                 names=None, ncols=5, cmap="turbo"):
    """Percentile-clipped scatter grid of (L, N) factors over (N, 2)
    coordinates; returns the matplotlib figure."""
    import matplotlib.pyplot as plt

    factors = np.asarray(factors)
    max_val = np.percentile(factors, 95)
    min_val = np.percentile(factors, 5)
    if moran_idx is not None:
        factors = factors[moran_idx]
        if names is not None:
            names = np.asarray(names)[moran_idx]

    L = len(factors)
    nrows = max(1, int(np.ceil(L / ncols)))
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(size * ncols, size * nrows), tight_layout=True
    )
    axes = np.atleast_2d(axes)
    for i in range(nrows * ncols):
        ax = axes[i // ncols, i % ncols]
        if i >= L:
            ax.axis("off")
            continue
        ax.scatter(coords[:, 0], coords[:, 1], c=factors[i], vmin=min_val,
                   vmax=max_val, alpha=alpha, cmap=cmap, s=s)
        ax.invert_yaxis()
        if names is not None:
            ax.set_title(str(names[i]), x=0.03, y=0.88, fontsize="small",
                         c="white", ha="left", va="top")
        ax.set_xticks([])
        ax.set_yticks([])
        ax.set_facecolor("gray")
    return fig
