"""Fréchet distance for FVD / FID — a copy of `dvdgan_tpu/eval/frechet.py`
(numpy only; the same features give the reference's value bitwise).

FVD(real, fake) = |μr − μf|² + tr(Σr + Σf − 2·(Σr Σf)^{1/2}) over clip
features from a (pretrained) video network. The matrix square root is
computed symmetrically — sqrtm(Σr Σf) has the same trace as
sqrt(Σr^{1/2} Σf Σr^{1/2}), which IS symmetric PSD, so an eigh suffices: no
scipy, float64 throughout.
"""

from __future__ import annotations

import numpy as np


def statistics(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """features: (N, D) -> (mean (D,), cov (D, D))."""
    f = np.asarray(features, np.float64)
    if f.ndim != 2:
        raise ValueError(f"features must be (N, D), got {f.shape}")
    if f.shape[0] < 2:
        # np.cov on one observation divides by N-1=0 and returns all-NaN,
        # which would propagate a silent nan FVD/FID into the results JSON
        raise ValueError(
            f"need >= 2 feature rows for a covariance, got {f.shape[0]}")
    mu = f.mean(axis=0)
    cov = np.cov(f, rowvar=False)
    return mu, np.atleast_2d(cov)


def _sqrtm_psd(m: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    vals, vecs = np.linalg.eigh((m + m.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals + eps)) @ vecs.T


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1 = np.asarray(cov1, np.float64)
    cov2 = np.asarray(cov2, np.float64)
    diff = mu1 - mu2
    s1 = _sqrtm_psd(cov1)
    inner = _sqrtm_psd(s1 @ cov2 @ s1)
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2.0 * np.trace(inner))


def frechet_from_features(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    return frechet_distance(*statistics(feats_a), *statistics(feats_b))
