"""BER-curve plot artifacts (PNG/SVG) (port of ``sdr_tpu/obs/plot.py``).

The terminal demo mirrors the reference's live Qt views; this module
covers the artifact side: a publication-style BER-vs-Eb/N0 curve from a
sweep result (``obs.sweep.SweepResult``, whose ``theory`` is the port's
``link.ber``), so a run leaves something a person can look at.
matplotlib is imported only when a figure is drawn.

Chart conventions (single log-y axis, thin 2px lines, recessive grid,
legend for >= 2 series, series colors in fixed categorical order from
a CVD-validated palette; theory reference drawn as a neutral dashed
line so color identifies ENTITIES, not ranks).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# Fixed categorical order (validated palette; never cycled).
_SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4", "#008300"]
_INK = "#1a1a19"
_MUTED = "#6b6a63"
_GRID = "#e5e4dd"


def plot_ber_curves(
    curves: Sequence[tuple],
    path: str,
    title: str = "BER vs Eb/N0",
    theory: Optional[tuple] = None,
    xlabel: str = "Eb/N0 [dB]",
    ylabel: str = "Bit error rate",
) -> str:
    """Render log-y curves to ``path`` (format from the extension).

    curves: [(label, x array, y array), ...] — at most 6 (categorical
    palette limit; fold more into separate figures).
    theory: optional ("label", x, y) drawn as a neutral dashed
    reference. Zero points (no events observed) are dropped from the
    log axis rather than plotted as lies. The default axis labels are
    the BER-sweep ones; waveform CCDFs etc. pass their own. Returns
    ``path``.
    """
    if len(curves) > len(_SERIES):
        raise ValueError(f"at most {len(_SERIES)} curves per figure")
    try:
        import matplotlib
    except ImportError as e:  # pragma: no cover - env-dependent
        raise RuntimeError(
            "plot output needs matplotlib; the sweep data itself is unaffected"
        ) from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4.6), dpi=150)
    fig.patch.set_facecolor("white")
    ax.set_facecolor("white")

    if theory is not None:
        tl, tx, ty = theory
        ty = np.asarray(ty, float)
        mask = ty > 0
        ax.semilogy(
            np.asarray(tx, float)[mask], ty[mask],
            ls="--", lw=1.6, color=_MUTED, label=tl, zorder=2,
        )
    for i, (label, ex, ey) in enumerate(curves):
        ex = np.asarray(ex, float)
        ey = np.asarray(ey, float)
        mask = ey > 0
        ax.semilogy(
            ex[mask], ey[mask],
            marker="o", ms=4.5, lw=2.0, color=_SERIES[i], label=label,
            zorder=3,
        )

    ax.set_xlabel(xlabel, color=_INK)
    ax.set_ylabel(ylabel, color=_INK)
    ax.set_title(title, color=_INK, fontsize=11, loc="left")
    ax.grid(True, which="major", color=_GRID, lw=0.8, zorder=0)
    ax.grid(True, which="minor", color=_GRID, lw=0.4, alpha=0.5, zorder=0)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    for spine in ("left", "bottom"):
        ax.spines[spine].set_color(_MUTED)
    ax.tick_params(colors=_MUTED, labelsize=9)
    if len(curves) + (theory is not None) >= 2:
        ax.legend(frameon=False, fontsize=9, labelcolor=_INK)
    fig.tight_layout()
    fig.savefig(path, facecolor="white")
    plt.close(fig)
    return path


def plot_sweep(result, mod, path: str, title: Optional[str] = None,
               channel_model=None, k_factor: float = 4.0, mimo=None) -> str:
    """Plot one ``obs.sweep.SweepResult`` against the exact theory
    curve for its channel (AWGN, flat-Rayleigh for Rayleigh/Jakes, the
    Rician MGF integral at ``k_factor``, or the exact diversity curve
    for Alamouti/MRC MIMO)."""
    name = getattr(mod, "value", str(mod))
    model_value = getattr(channel_model, "value", "")
    scheme_value = getattr(getattr(mimo, "scheme", None), "value", "")
    if scheme_value in ("alamouti", "mrc") and model_value == "rayleigh_flat":
        label = f"{scheme_value} {mimo.n_tx}x{mimo.n_rx} theory"
    elif model_value.startswith("rayleigh"):
        label = "Rayleigh theory"
    elif model_value == "rician":
        label = f"Rician theory (K={k_factor:g})"
    else:
        label = "AWGN theory"
    return plot_ber_curves(
        [(f"measured ({name})", result.ebnos(), result.bers())],
        path,
        title=title or f"BER vs Eb/N0 — {result.config_summary}",
        theory=(
            label,
            result.ebnos(),
            result.theory(mod, channel_model, k_factor=k_factor, mimo=mimo),
        ),
    )
