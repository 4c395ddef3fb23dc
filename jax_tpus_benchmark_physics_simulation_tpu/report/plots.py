"""Plotting: benchmark scaling plot (feature parity with utils/plt.py),
plus per-workload figures (RDF, GW strain, VMC/DMC histories).

The benchmark plot keeps the reference's exact layout (utils/plt.py:20-135):
two stacked axes (TFLOPS + twin bandwidth axis over cores; latency below),
per-test colors/markers, point value labels, shared legend.
"""

from __future__ import annotations

import os
from typing import List, Optional

import matplotlib

# Headless-safe default; an interactive backend survives when a display is
# available so ``show=True`` (the reference's plt.show(),
# molecular_dynamics...:190) can work. Override with MPLBACKEND.
if not os.environ.get("DISPLAY") and not os.environ.get("MPLBACKEND"):
    matplotlib.use("Agg")
import matplotlib.pyplot as plt


def _finish(fig, output, show: bool, **savefig_kw) -> str:
    fig.savefig(output, **savefig_kw)
    if show:  # no-op under Agg (headless); real display with a GUI backend
        plt.show()
    plt.close(fig)
    return output
import numpy as np

STYLE_MAP = {
    "2D": {"color": "tab:blue", "marker": "o", "label": "2D MatMul"},
    "3D": {"color": "tab:green", "marker": "s", "label": "3D MatMul"},
    "2D_FFT": {"color": "tab:red", "marker": "^", "label": "2D FFT"},
    "3D_FFT": {"color": "tab:orange", "marker": "v", "label": "3D FFT"},
    "Conv": {"color": "tab:brown", "marker": "*", "label": "Conv2D"},
    "Bandwidth": {"color": "tab:purple", "marker": "d", "label": "Bandwidth"},
}


def plot_benchmark_results(results: List[dict], output: str = "benchmark_results.png", show: bool = False) -> Optional[str]:
    if not results:
        return None
    tests = sorted({r["test"] for r in results})
    by_test = {
        t: sorted((r for r in results if r["test"] == t), key=lambda r: r["cores"])
        for t in tests
    }
    all_cores = sorted({r["cores"] for r in results})

    fig, (ax_perf, ax_time) = plt.subplots(2, 1, figsize=(14, 12), sharex=True)
    fig.suptitle("Benchmark Results", fontsize=18, weight="bold")

    ax_perf.set_title("Performance (Higher is Better)", fontsize=14)
    ax_perf.set_ylabel("TFLOPS", fontsize=12, color="tab:cyan")
    ax_perf.grid(True, linestyle="--", alpha=0.6)
    ax_perf.set_xticks(all_cores)
    ax_bw = ax_perf.twinx()
    ax_bw.set_ylabel("Bandwidth (GB/s)", fontsize=12, color="tab:purple")

    ax_time.set_title("Latency (Lower is Better)", fontsize=14)
    ax_time.set_ylabel("Avg. Time (ms)", fontsize=12)
    ax_time.set_xlabel("Number of Devices", fontsize=12)
    ax_time.grid(True, linestyle="--", alpha=0.6)

    handles = []
    for t in tests:
        rows = by_test[t]
        style = STYLE_MAP.get(t, {"color": "gray", "marker": "x", "label": t})
        cores = [r["cores"] for r in rows]
        handles.append(
            plt.Line2D([0], [0], color=style["color"], marker=style["marker"], label=style["label"])
        )
        if t == "Bandwidth":
            vals = [r.get("bandwidth_gbs", 0) for r in rows]
            ax_bw.plot(cores, vals, marker=style["marker"], color=style["color"])
            for c, v in zip(cores, vals):
                ax_bw.text(c, v, f" {v:.1f} GB/s", va="bottom", ha="center", color=style["color"], size="small")
        else:
            vals = [r.get("tflops", 0) for r in rows]
            ax_perf.plot(cores, vals, marker=style["marker"], color=style["color"])
            for c, v in zip(cores, vals):
                ax_perf.text(c, v, f" {v:.1f} T", va="bottom", ha="center", color=style["color"], size="small")
        ms = [r.get("avg_ms", 0) for r in rows]
        ax_time.plot(cores, ms, marker=style["marker"], color=style["color"], linestyle="--")
        for c, v in zip(cores, ms):
            ax_time.text(c, v, f" {v:.2f} ms", va="top", ha="center", color=style["color"], size="small")

    handles.append(plt.Line2D([0], [0], color="gray", linestyle="-", label="Performance"))
    handles.append(plt.Line2D([0], [0], color="gray", linestyle="--", label="Latency (ms)"))
    fig.legend(handles=handles, loc="lower center", bbox_to_anchor=(0.5, 0.01), ncol=min(len(handles), 4))
    fig.tight_layout(rect=[0, 0.05, 1, 0.95])
    _finish(fig, output, show, dpi=150)
    return output


def plot_rdf(r, g, n, rho, kt, output: str = "g_r_plot.png", show: bool = False) -> str:
    """RDF figure (reference molecular_dynamics...:179-189 layout)."""
    fig = plt.figure(figsize=(10, 6))
    plt.plot(np.asarray(r), np.asarray(g), marker="o", markersize=4, linestyle="-")
    plt.title(f"Radial Distribution Function g(r) - N={n}, rho={rho}, kT={kt}")
    plt.xlabel(r"Distance r (in units of $\sigma$)")
    plt.ylabel("g(r)")
    plt.grid(True, linestyle="--", alpha=0.6)
    plt.axhline(1.0, color="grey", linestyle="--")
    _finish(fig, output, show, dpi=300, bbox_inches="tight")
    return output


def plot_msd(
    msd, dt_sample: float, d_coef: float, output: str = "msd_plot.png",
    show: bool = False,
) -> str:
    """MSD curve + Einstein-relation fit line (no reference analog — the
    reference computes no transport observables)."""
    msd = np.asarray(msd)
    t = np.arange(msd.shape[0]) * dt_sample
    fig = plt.figure(figsize=(10, 6))
    plt.plot(t, msd, marker="o", markersize=4, linestyle="-", label="MSD")
    k0 = msd.shape[0] // 2
    if np.isfinite(d_coef) and msd.shape[0] >= 4:
        # the fit line is reconstructed from the same window the D fit used
        slope, icept = np.polyfit(t[k0:], msd[k0:], 1)
        plt.plot(t[k0:], icept + slope * t[k0:], "--",
                 label=f"fit: D = {d_coef:.3e}")
    plt.title("Mean-squared displacement (sliding-origin)")
    plt.xlabel("lag time")
    plt.ylabel(r"$\langle |\Delta r|^2 \rangle$")
    plt.grid(True, linestyle="--", alpha=0.6)
    plt.legend()
    _finish(fig, output, show, dpi=300, bbox_inches="tight")
    return output


def plot_gw_strain(t, h_plus, output: str = "n_body_gw_plot.png") -> str:
    """GW waveform figure (reference nbody...:212-218)."""
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(np.asarray(t), np.asarray(h_plus), label="Multi-Body h+", color="red")
    ax.set_xlabel("Time")
    ax.set_ylabel("Strain")
    ax.set_title("N-Body Gravitational Waveform")
    ax.legend()
    ax.grid(True)
    fig.savefig(output)
    plt.close(fig)
    return output


def plot_trajectories_3d(t, positions, output: str = "n_body_3d_plot.png") -> str:
    """(x, y, time) trajectory plot (reference nbody...:229-237)."""
    positions = np.asarray(positions)
    t = np.asarray(t)
    n_bodies = positions.shape[1]
    colors = plt.cm.Set1(np.linspace(0, 1, n_bodies))
    fig = plt.figure(figsize=(12, 8))
    ax = fig.add_subplot(111, projection="3d")
    for i in range(n_bodies):
        ax.plot(positions[:, i, 0], positions[:, i, 1], t, color=colors[i], label=f"Body {i + 1}")
    ax.set_xlabel("X"); ax.set_ylabel("Y"); ax.set_zlabel("Time")
    ax.set_title("N-Body Trajectories")
    ax.legend()
    fig.savefig(output)
    plt.close(fig)
    return output


def plot_vmc_history(energies, alphas, exact_e, exact_alpha, output: str = "vmc_history.png") -> str:
    """Energy + alpha convergence panels (reference vmc_dmc...:185-198)."""
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 8), sharex=True)
    ax1.plot(np.asarray(energies), label="VMC Energy")
    ax1.axhline(exact_e, color="r", linestyle="--", label=f"Exact $E_0 = {exact_e}$")
    ax1.set_ylabel("Energy")
    ax1.legend()
    ax1.set_title("VMC Optimization")
    ax2.plot(np.asarray(alphas), label=r"$\alpha$")
    if exact_alpha is not None:  # no closed-form optimum for anharmonic trials
        ax2.axhline(exact_alpha, color="r", linestyle="--",
                    label=rf"Exact $\alpha = {exact_alpha}$")
    ax2.set_xlabel("Epoch")
    ax2.set_ylabel(r"$\alpha$")
    ax2.legend()
    fig.tight_layout()
    fig.savefig(output)
    plt.close(fig)
    return output


def plot_walker_comparison(
    vmc_walkers,
    dmc_walkers,
    exact_sigma: float,
    output: str = "walker_distributions.png",
) -> str:
    """Final VMC vs DMC walker x-marginals vs exact ground state
    (reference vmc_dmc...:333-345)."""
    x = np.linspace(-3, 3, 200)
    psi2 = np.exp(-0.5 * (x / exact_sigma) ** 2)
    psi2 /= np.trapezoid(psi2, x)
    fig = plt.figure(figsize=(10, 6))
    plt.hist(np.asarray(vmc_walkers)[:, 0], bins=50, density=True, alpha=0.6, label="VMC Walkers (Final)")
    plt.hist(np.asarray(dmc_walkers)[:, 0], bins=50, density=True, alpha=0.6, color="green", label="DMC Walkers (Final)")
    plt.plot(x, psi2, "r-", linewidth=2, label=r"Exact Marginal $|\Psi_0|^2$")
    plt.title("Final Walker Distribution Marginal (VMC vs DMC vs Exact)")
    plt.xlabel("Position (x)")
    plt.ylabel(r"$|\Psi(x)|^2$")
    plt.legend()
    plt.savefig(output)
    plt.close(fig)
    return output


def plot_dmc_energy(energy_history, exact_e, burn_in: int = 100, output: str = "dmc_energy.png") -> str:
    """DMC E_ref trace with mean +- stderr (reference vmc_dmc...:316-331)."""
    e = np.asarray(energy_history)
    post = e[burn_in:]
    mean = post.mean()
    stderr = post.std() / np.sqrt(max(len(post), 1))
    fig = plt.figure(figsize=(10, 6))
    plt.plot(post, label=f"DMC $E_{{ref}}$ after step {burn_in}")
    plt.axhline(mean, color="b", linestyle="--", label=f"DMC Mean = {mean:.6f} $\\pm$ {stderr:.6f}")
    plt.axhline(exact_e, color="r", linestyle=":", label=f"Exact $E_0 = {exact_e}$")
    plt.xlabel("DMC Step")
    plt.ylabel("Energy")
    plt.legend()
    plt.savefig(output)
    plt.close(fig)
    return output
