"""Spectrogram and histogram images of the training visuals: a copy of
``mdctgan_tpu/utils/spectro_img.py`` (the reference's
``util/spectro_img.py``).

matplotlib (Agg backend) renders a normalized MDCT spectrogram into RGB
arrays for TensorBoard and the HTML gallery.  It is imported at the first
render, and where it is absent the renders are ``None``: headless training
never depends on it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def _fig_to_rgb(fig) -> np.ndarray:
    fig.canvas.draw()
    w, h = fig.canvas.get_width_height()
    buf = np.frombuffer(fig.canvas.buffer_rgba(), np.uint8).reshape(h, w, 4)
    return buf[..., :3].copy()


def compute_visuals(spectro: np.ndarray, abs_spectro: bool = False
                    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(spectro_img, hist_img) RGB uint8 arrays, or (None, None) without
    matplotlib.  ``spectro`` is one (F, K) spectrogram in the model's
    (time, freq) layout, transposed so that frequency runs up; with
    ``abs_spectro`` the map shows magnitudes while the histogram keeps the
    signed values."""
    plt = _pyplot()
    if plt is None:
        return None, None
    s = np.asarray(spectro).squeeze().T
    fig, ax = plt.subplots(figsize=(6, 4), dpi=80)
    m = ax.pcolormesh(np.abs(s) if abs_spectro else s, cmap="magma")
    fig.colorbar(m, ax=ax)
    spec_img = _fig_to_rgb(fig)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(6, 4), dpi=80)
    ax.hist(s.ravel(), bins=100)
    hist_img = _fig_to_rgb(fig)
    plt.close(fig)
    return spec_img, hist_img


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def display_spectra(cfg, lr_spec, sr_spec, hr_spec, lr_np, hr_np) -> Dict[str, np.ndarray]:
    """The display visuals in the denormalized (arcsinh) domain, as the
    reference registers them: each normalized spectrum mapped back through
    its normalisation bounds, the SR one with the **LR** bounds and clipped
    to HR's range.  ``explicit_encoding`` shows the mean of the two sign
    channels instead, and a mode without arcsinh the normalized spectrum.

    Spectra are (B, C, F, K) tensors or arrays, bounds ``{"min", "max"}``
    of floats (``abs_norm``) or of per-sample (B, C, 1, 1) tensors or
    arrays, on any device; returns ``{lr,sr,hr}_spectro``, each the first
    item's (F, K) array."""
    lr, sr, hr = _host(lr_spec), _host(sr_spec), _host(hr_spec)
    if cfg.explicit_encoding:
        return {
            "lr_spectro": 0.5 * (lr[0, 0] + lr[0, 1]),
            "sr_spectro": 0.5 * (sr[0, 0] + sr[0, 1]),
            "hr_spectro": 0.5 * (hr[0, 0] + hr[0, 1]),
        }
    if not cfg.arcsinh_transform:
        return {"lr_spectro": lr[0, 0], "sr_spectro": sr[0, 0], "hr_spectro": hr[0, 0]}
    lo, hi = cfg.norm_range
    span = hi - lo

    def denorm(x, p):
        u = (x - lo) / span
        pmin, pmax = _host(p["min"]), _host(p["max"])
        return u * (pmax - pmin) + pmin

    gen = denorm(sr, lr_np)  # the LR bounds, as the reference does
    gen = np.clip(gen, _host(hr_np["min"]), _host(hr_np["max"]))
    return {
        "lr_spectro": denorm(lr, lr_np)[0, 0],
        "sr_spectro": gen[0, 0],
        "hr_spectro": denorm(hr, hr_np)[0, 0],
    }
