"""Circuit layout renderer: column/row occupancy visualization.

Counterpart of ``zerog_tpu/plonk/layout.py`` (`halo2_proofs::dev::CircuitLayout`
+ plotters; reference src/gadgets/wnn.rs:287-297 `plot_circuit` and the
per-gadget `plot()` tests). Renders cell occupancy of advice/fixed columns
(selector fires highlighted) to a PNG via matplotlib, imported inside the
function.
"""

from __future__ import annotations

import numpy as np

from .assignment import Assignment

__all__ = ["render_layout"]


def render_layout(assignment: Assignment, filename: str, max_rows: int | None = None,
                  title: str = "Circuit Layout"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cs = assignment.cs
    n = assignment.n if max_rows is None else min(assignment.n, max_rows)
    num_cols = cs.num_advice + cs.num_fixed
    grid = np.zeros((n, num_cols), dtype=np.uint8)

    for j, col in enumerate(assignment.advice):
        nz = np.asarray([bool(v) for v in col[:n]])
        grid[nz, j] = 1
    for j, col in enumerate(assignment.fixed):
        nz = np.asarray([bool(v) for v in col[:n]])
        kind = 3 if j in cs.selector_fixed else (4 if j in cs.table_fixed else 2)
        grid[nz, cs.num_advice + j] = kind

    fig, ax = plt.subplots(figsize=(max(6, num_cols * 0.4), 10))
    cmap = matplotlib.colors.ListedColormap(
        ["#ffffff", "#d62728", "#1f77b4", "#2ca02c", "#9467bd"]
    )
    ax.imshow(grid, aspect="auto", interpolation="nearest", cmap=cmap, vmin=0, vmax=4)
    ax.axvline(cs.num_advice - 0.5, color="black", lw=1)
    ax.set_xlabel(f"columns (advice 0..{cs.num_advice - 1} | fixed)")
    ax.set_ylabel("rows")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(filename, dpi=100)
    plt.close(fig)
    return filename
