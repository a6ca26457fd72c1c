"""Frechet Inception Distance over the port's InceptionV3 (port of
``ccedit_tpu/utils/fid.py``).

``activations``: the 2048-d pool features of (H, W, 3) images in [0, 1],
in batches on the model's device; ``statistics``: their mean and
covariance; ``frechet_distance``: ||mu1 - mu2||^2 + tr(S1 + S2 - 2
sqrt(S1 S2)) with scipy's ``sqrtm`` on the host and ``pytorch_fid``'s
retry with eps on the diagonal when the product is near singular; ``fid``:
the distance between two image sets.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch


def fid_inception(device=None):
    """InceptionV3 as FID uses it: resize to 299, [0, 1] -> [-1, 1]."""
    from ..modules.inception import InceptionV3

    with torch.device(device or "cpu"):
        return InceptionV3(resize_input=True, normalize_input=True).eval()


@torch.no_grad()
def activations(model, images: Iterable[np.ndarray], batch_size: int = 16) -> np.ndarray:
    """images: (H, W, 3) float arrays in [0, 1] -> (N, 2048) fp32."""
    device = model.Conv2d_1a_3x3.conv.weight.device
    feats, batch = [], []

    def flush():
        x = torch.from_numpy(np.stack(batch).astype(np.float32)).to(device)
        feats.append(model(x)[-1].float().cpu().numpy())
        batch.clear()

    for img in images:
        batch.append(np.asarray(img, np.float32))
        if len(batch) == batch_size:
            flush()
    if batch:
        flush()
    return np.concatenate(feats, axis=0)


def statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


def _sqrtm(m: np.ndarray) -> np.ndarray:
    """scipy's matrix square root, without its error estimate (SciPy 1.16
    dropped the ``disp`` argument that the older ones need for that)."""
    from scipy import linalg

    try:
        return linalg.sqrtm(m, disp=False)[0]
    except TypeError:
        return linalg.sqrtm(m)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """``pytorch_fid``'s ``calculate_frechet_distance``."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("non-negligible imaginary component in sqrtm")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid(model, images_a, images_b, batch_size: int = 16) -> float:
    fa = activations(model, images_a, batch_size)
    fb = activations(model, images_b, batch_size)
    return frechet_distance(*statistics(fa), *statistics(fb))
