"""Local perceptual quality scorers (zero-egress VQA/CLIP/ITM stand-ins).

The reference scores generated video with downloaded perceptual models —
VQAScore (clip-flant5-xxl), CLIPScore (ViT-L-14-336), ITMScore (blip2-itm)
(reference example/eval/evaluate.py:9-36). This image has no model egress,
so the perceptual role is filled by three self-contained scorers that go
beyond raw tensor cosine/PSNR:

* :func:`ssim` — structural similarity (luminance/contrast/structure over a
  sliding window), the classic perceptual metric;
* :func:`freq_band_mse` — 2-D FFT band-split MSE (low/mid/high spatial
  frequency), which separates "blurry but close" from "sharp but ringing"
  degradations that a flat MSE conflates;
* :func:`random_feature_distance` — cosine similarity in the feature space
  of a small FIXED-weight conv stack (seeded Gaussian filters + ReLU).
  Random convolutional features are a standard no-training perceptual
  proxy: quantization artifacts that perturb textures/edges move these
  features far more than they move raw pixels.

All scorers take float arrays shaped [..., H, W] (leading dims are
batch/frames) and reduce to one float.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "ssim",
    "freq_band_mse",
    "random_feature_distance",
    "perceptual_report",
    "latent_to_frames",
]


def _window_means(x: np.ndarray, win: int) -> np.ndarray:
    """Mean over all win x win windows of the trailing two axes (valid
    padding) via the 2-D cumulative-sum (integral image) trick."""
    cs = np.cumsum(np.cumsum(x, axis=-1), axis=-2)
    cs = np.pad(cs, [(0, 0)] * (x.ndim - 2) + [(1, 0), (1, 0)])
    tot = (
        cs[..., win:, win:]
        - cs[..., :-win, win:]
        - cs[..., win:, :-win]
        + cs[..., :-win, :-win]
    )
    return tot / float(win * win)


def ssim(a: np.ndarray, b: np.ndarray, win: int = 7) -> float:
    """Mean structural similarity between two frame stacks [..., H, W].

    Uniform win x win windows (the integral-image form), with the standard
    stabilizers C1/C2 derived from the BASELINE's dynamic range — so the
    score is calibrated by the reference generation, not the degraded one.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    if min(a.shape[-1], a.shape[-2]) < win:
        win = min(a.shape[-1], a.shape[-2])
    drange = float(b.max() - b.min()) or 1.0
    c1, c2 = (0.01 * drange) ** 2, (0.03 * drange) ** 2
    mu_a, mu_b = _window_means(a, win), _window_means(b, win)
    var_a = _window_means(a * a, win) - mu_a * mu_a
    var_b = _window_means(b * b, win) - mu_b * mu_b
    cov = _window_means(a * b, win) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)
    return float(np.mean(num / den))


def freq_band_mse(a: np.ndarray, b: np.ndarray) -> dict:
    """MSE between 2-D spectra split into three radial frequency bands.

    Returns {"low": ..., "mid": ..., "high": ...} — low-band error reads as
    global luminance/shape drift, high-band as texture/edge noise (the
    signature of aggressive quantization).
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    fa = np.fft.fftshift(np.fft.fft2(a), axes=(-2, -1))
    fb = np.fft.fftshift(np.fft.fft2(b), axes=(-2, -1))
    h, w = a.shape[-2:]
    yy = (np.arange(h) - h / 2.0) / (h / 2.0)
    xx = (np.arange(w) - w / 2.0) / (w / 2.0)
    r = np.sqrt(yy[:, None] ** 2 + xx[None, :] ** 2)
    bands = {"low": r < 1 / 3, "mid": (r >= 1 / 3) & (r < 2 / 3), "high": r >= 2 / 3}
    err = np.abs(fa - fb) ** 2
    norm = a.shape[-1] * a.shape[-2]
    return {
        name: float(np.mean(err[..., mask]) / norm) for name, mask in bands.items()
    }


def _fixed_filters(n_out: int, n_in: int, k: int, seed: int) -> np.ndarray:
    """Deterministic Gaussian conv filters [n_out, n_in, k, k], unit-norm
    per output channel (a fixed random feature basis — never trained)."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n_out, n_in, k, k))
    f -= f.mean(axis=(1, 2, 3), keepdims=True)  # zero-DC: respond to structure
    f /= np.linalg.norm(f.reshape(n_out, -1), axis=1)[:, None, None, None]
    return f


def _conv2d_valid(x: np.ndarray, f: np.ndarray) -> np.ndarray:
    """x [B, Cin, H, W] * f [Cout, Cin, k, k] -> [B, Cout, H', W'] via
    sliding windows (small k, eval-path only — clarity over speed)."""
    k = f.shape[-1]
    win = np.lib.stride_tricks.sliding_window_view(x, (k, k), axis=(-2, -1))
    # win: [B, Cin, H', W', k, k]
    return np.einsum("bchwij,ocij->bohw", win, f)


def random_feature_distance(a: np.ndarray, b: np.ndarray, *,
                            depth: int = 3, width: int = 8,
                            seed: int = 42) -> float:
    """Cosine similarity of fixed random conv-net features (1.0 == same).

    A ``depth``-layer stack of seeded 3x3 Gaussian filters with ReLU and
    2x2 mean-pooling; the per-layer feature cosines are averaged. Fills the
    learned-model (CLIP/ITM) slot with a reproducible no-download proxy.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    lead = a.shape[:-2]
    xa = a.reshape((-1, 1) + a.shape[-2:])
    xb = b.reshape((-1, 1) + b.shape[-2:])
    scale = np.abs(xb).max() or 1.0
    xa, xb = xa / scale, xb / scale
    del lead
    sims = []
    c_in = 1
    for layer in range(depth):
        if min(xa.shape[-2:]) < 3:  # too small for another 3x3 conv
            break
        f = _fixed_filters(width, c_in, 3, seed + layer)
        xa = np.maximum(_conv2d_valid(xa, f), 0.0)
        xb = np.maximum(_conv2d_valid(xb, f), 0.0)
        va, vb = xa.ravel(), xb.ravel()
        denom = np.linalg.norm(va) * np.linalg.norm(vb)
        sims.append(float(va @ vb / denom) if denom else 1.0)
        # 2x2 mean pool
        h, w = xa.shape[-2] // 2 * 2, xa.shape[-1] // 2 * 2
        if h < 2 or w < 2:
            break
        xa = xa[..., :h, :w].reshape(*xa.shape[:-2], h // 2, 2, w // 2, 2).mean((-3, -1))
        xb = xb[..., :h, :w].reshape(*xb.shape[:-2], h // 2, 2, w // 2, 2).mean((-3, -1))
        c_in = width
    return float(np.mean(sims))


def latent_to_frames(x: np.ndarray) -> np.ndarray:
    """DiT latent [B, S, D] -> frame stack [B*D', H, W] for the image
    scorers: tokens become the near-square spatial grid they patchify
    (trailing remainder dropped), a few channel slices become frames."""
    x = np.asarray(x, np.float32)
    if x.ndim == 2:
        x = x[None]
    b, s, d = x.shape
    h = int(np.sqrt(s))
    while s % h:
        h -= 1
    w = s // h
    n_ch = min(d, 4)  # a few channel-planes stand in for frames
    return x[..., :n_ch].reshape(b, h, w, n_ch).transpose(0, 3, 1, 2).reshape(
        b * n_ch, h, w
    )


def perceptual_report(frames: np.ndarray, baseline: np.ndarray) -> dict:
    """All perceptual scores in one dict (the per-impl row the eval harness
    writes to eval_out/result.json)."""
    bands = freq_band_mse(frames, baseline)
    return {
        "ssim": ssim(frames, baseline),
        "feature_cos": random_feature_distance(frames, baseline),
        "freq_mse_low": bands["low"],
        "freq_mse_mid": bands["mid"],
        "freq_mse_high": bands["high"],
    }
