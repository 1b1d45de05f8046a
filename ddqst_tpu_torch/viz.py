"""Visualization artifacts: state city plots, error heatmaps, eval plots.

The port's copy of ``ddqst_tpu/viz.py``: the reference's plotting surface
without qiskit (state-city and error-heatmap PNGs of a reconstruction, and
the evaluation harness's fidelity-lift scatter and fidelity-vs-depth
plot). matplotlib is imported on first use, with the ``Agg`` backend, so
importing this module needs no matplotlib.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_state_city(rho: np.ndarray, title: str = "", path: str = "state_city.png"):
    """3-D bar plot of Re(ρ) and Im(ρ) (qiskit ``plot_state_city`` analogue)."""
    plt = _plt()
    d = rho.shape[0]
    xs, ys = np.meshgrid(np.arange(d), np.arange(d), indexing="ij")
    fig = plt.figure(figsize=(12, 5))
    for k, (part, name) in enumerate(
        [(np.real(rho), "Re(ρ)"), (np.imag(rho), "Im(ρ)")]
    ):
        ax = fig.add_subplot(1, 2, k + 1, projection="3d")
        ax.bar3d(
            xs.ravel(), ys.ravel(), np.zeros(d * d),
            0.7, 0.7, part.ravel(),
            color=plt.cm.viridis((part.ravel() + 1) / 2), shade=True,
        )
        ax.set_title(name)
        ax.set_zlim(-1, 1)
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=200)
    plt.close(fig)
    return path


def plot_error_heatmap(
    target: np.ndarray, rho: np.ndarray, path: str = "error_heatmap.png"
):
    """|target - rho| magnitude heatmap (``main.py:40-51``)."""
    plt = _plt()
    diff = np.abs(np.asarray(target) - np.asarray(rho))
    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(diff, cmap="Reds")
    fig.colorbar(im, ax=ax)
    ax.set_title(
        f"Reconstruction Error Magnitude\nAvg Abs Error: {diff.mean():.5f}"
    )
    fig.tight_layout()
    fig.savefig(path, dpi=200)
    plt.close(fig)
    return path


def plot_fidelity_lift(records: list[dict], path: str = "fidelity_lift.png"):
    """Raw vs D3PM fidelity scatter with the identity line
    (``evaluate.py:105-110``)."""
    plt = _plt()
    raw = np.array([r["raw_fidelity"] for r in records])
    d3pm = np.array([r["d3pm_fidelity"] for r in records])
    depth = np.array([r["depth"] for r in records])
    fig, ax = plt.subplots(figsize=(7, 7))
    sc = ax.scatter(raw, d3pm, c=depth, cmap="viridis", s=60)
    fig.colorbar(sc, ax=ax, label="circuit depth")
    lo = min(raw.min(), d3pm.min(), 0.0)
    ax.plot([lo, 1], [lo, 1], "r--", label="identity")
    ax.set_xlabel("Raw fidelity (linear inversion on measured data)")
    ax.set_ylabel("D3PM fidelity")
    ax.set_title("Fidelity Lift")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=200)
    plt.close(fig)
    return path


def plot_universality(records: list[dict], path: str = "universality.png"):
    """Mean fidelity vs circuit depth for both methods (``evaluate.py:112-116``)."""
    plt = _plt()
    depths = sorted({r["depth"] for r in records})
    raw_m, d3_m = [], []
    for d in depths:
        sel = [r for r in records if r["depth"] == d]
        raw_m.append(np.mean([r["raw_fidelity"] for r in sel]))
        d3_m.append(np.mean([r["d3pm_fidelity"] for r in sel]))
    fig, ax = plt.subplots(figsize=(9, 5))
    ax.plot(depths, raw_m, "o-", label="Raw")
    ax.plot(depths, d3_m, "s-", label="D3PM")
    ax.set_xlabel("circuit depth")
    ax.set_ylabel("fidelity")
    ax.set_title("Reconstruction vs Circuit Depth")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=200)
    plt.close(fig)
    return path


def plot_losses(losses: np.ndarray, path: str = "loss.png"):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(losses)
    ax.set_xlabel("epoch")
    ax.set_ylabel("denoising CE loss")
    fig.tight_layout()
    fig.savefig(path, dpi=200)
    plt.close(fig)
    return path
