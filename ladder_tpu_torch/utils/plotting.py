"""Plot helpers (the port of ``ladder_tpu/utils/plotting.py``; so far the
one the interpolation demo draws with). matplotlib is imported inside the
functions: the package imports torch, numpy and the standard library only,
and the card's machine has no matplotlib."""

from __future__ import annotations

import numpy as np


def pyplot():
    """matplotlib.pyplot on the Agg backend, or an ImportError that names
    matplotlib."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def draw_ellipse(position, covariance, weight, ax=None, color="r"):
    """2-sigma ellipse of one mixture component (the reference's
    base.py:825-841)."""
    plt = pyplot()
    from matplotlib.patches import Ellipse

    ax = ax or plt.gca()
    covariance = np.asarray(covariance)
    if covariance.shape == (2, 2):
        U, s, _ = np.linalg.svd(covariance)
        angle = np.degrees(np.arctan2(U[1, 0], U[0, 0]))
        width, height = 2 * np.sqrt(s)
    else:
        angle = 0
        width, height = 2 * np.sqrt(covariance)
    nsig = 2
    ax.add_patch(Ellipse(np.asarray(position), nsig * width, nsig * height,
                         angle=angle, color=color, fill=False,
                         lw=weight * 10))
