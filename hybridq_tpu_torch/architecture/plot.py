"""Layout plotting (optional; requires matplotlib)."""

from __future__ import annotations

__all__ = ['plot_qubits']


def plot_qubits(qpu_layout, couplings=None, selected_qubits=None,
                figsize=(8, 8), annotate: bool = True):
    """Scatter-plot a QPU layout, optionally drawing couplings and
    highlighting selected qubits.  Returns the matplotlib figure."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(
            "'plot_qubits' requires matplotlib, which is not installed "
            "in this environment.") from e

    fig, ax = plt.subplots(figsize=figsize)
    xs = [x for x, _ in qpu_layout]
    ys = [y for _, y in qpu_layout]
    ax.scatter(xs, ys, s=200, c='lightblue', edgecolors='k', zorder=2)
    if couplings:
        for (x1, y1), (x2, y2) in couplings:
            ax.plot([x1, x2], [y1, y2], 'k-', lw=1, zorder=1)
    if selected_qubits:
        sel = [q for q in qpu_layout if q in set(selected_qubits)]
        ax.scatter([x for x, _ in sel], [y for _, y in sel], s=200,
                   c='orange', edgecolors='k', zorder=3)
    if annotate:
        for x, y in qpu_layout:
            ax.annotate(f'{x},{y}', (x, y), ha='center', va='center',
                        fontsize=6, zorder=4)
    ax.set_aspect('equal')
    return fig
