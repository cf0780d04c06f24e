"""Quality metrics (counterpart of gigagan_tpu/eval.py): CLIP-score and
the Fréchet distance of CLIP image embeddings (CLIP-FID), with the same
numerics.

- **CLIP-FID**: the Fréchet distance between Gaussian fits of the CLIP
  image embeddings of a real and a generated image set.
- **CLIP-score**: ``100 · mean(max(cos(e_img, e_txt), 0))``.

Both run through the port's ``OpenClipAdapter``: with an open_clip
checkpoint on disk (``pretrained=``) they are pretrained-feature metrics;
without one they run end to end on random-init CLIP, and every result
carries ``mock_reasons`` so that such a number cannot pass for a real
one.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from gigagan_tpu_torch.utils import exists

__all__ = [
    "gaussian_stats",
    "frechet_distance",
    "clip_score",
    "QualityEvaluator",
]


def gaussian_stats(embeds):
    """Mean and covariance of an (n, d) embedding set, in float64 (the
    Fréchet sqrtm is ill-conditioned in float32 at small n)."""
    x = np.asarray(embeds, dtype=np.float64)
    assert x.ndim == 2 and x.shape[0] >= 2, (
        f"need an (n>=2, d) embedding matrix, got {x.shape}"
    )
    mu = x.mean(axis=0)
    cov = np.cov(x, rowvar=False)
    return mu, np.atleast_2d(cov)


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6):
    """Fréchet distance between two Gaussians:
    |mu1-mu2|^2 + tr(c1 + c2 - 2 (c1 c2)^{1/2}).

    The standard FID guards: jitter the diagonal when sqrtm gives a
    non-finite result, and drop the imaginary part when it is numerical
    noise."""
    from scipy import linalg

    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1 = np.atleast_2d(np.asarray(cov1, np.float64))
    cov2 = np.atleast_2d(np.asarray(cov2, np.float64))
    diff = mu1 - mu2

    covmean = np.asarray(linalg.sqrtm(cov1 @ cov2))
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = np.asarray(
            linalg.sqrtm((cov1 + offset) @ (cov2 + offset))
        )
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"sqrtm produced a significantly imaginary component "
                f"({np.max(np.abs(covmean.imag))})"
            )
        covmean = covmean.real
    return float(
        diff @ diff + np.trace(cov1) + np.trace(cov2)
        - 2.0 * np.trace(covmean)
    )


def clip_score(image_embeds, text_embeds):
    """CLIPScore = 100 * mean(max(cos, 0)) over matched (image, text)
    rows; both inputs must be l2-normalised (n, d)."""
    ie = _numpy(image_embeds)
    te = _numpy(text_embeds)
    assert ie.shape == te.shape, (ie.shape, te.shape)
    cos = np.sum(ie * te, axis=-1)
    return float(100.0 * np.mean(np.maximum(cos, 0.0)))


def _numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float64)


class QualityEvaluator:
    """Embeds image sets through a CLIP adapter, in batches on the
    adapter's device, and computes CLIP-FID / CLIP-score.  ``clip`` is an
    ``OpenClipAdapter`` (real weights when a checkpoint is on disk,
    random-init otherwise: see ``mock_reasons``)."""

    def __init__(self, clip, batch_size: int = 32):
        self.clip = clip
        self.batch_size = batch_size

    @property
    def mock_reasons(self) -> List[str]:
        return list(getattr(self.clip, "mock_reasons", []))

    @property
    def is_real(self) -> bool:
        """True when the CLIP runs pretrained weights and a real BPE
        tokenizer, so that the numbers compare across machines."""
        return not self.mock_reasons

    @torch.inference_mode()
    def embed_images(self, images) -> np.ndarray:
        """(n, h, w, 3) images in [0, 1] (numpy or tensor; any h) → (n, d)
        l2-normalised CLIP embeds, float32."""
        images = torch.as_tensor(np.asarray(images, np.float32)
                                 if not torch.is_tensor(images) else images)
        assert images.ndim == 4 and images.shape[-1] == 3, images.shape
        outs = []
        for i in range(0, images.shape[0], self.batch_size):
            batch = images[i: i + self.batch_size].to(self.clip.device,
                                                      torch.float32)
            embed, _ = self.clip.embed_images(batch)
            outs.append(embed.float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    def clip_fid(self, real_images, fake_images) -> dict:
        """CLIP-FID between two image sets: the value, the sample counts
        and whether the CLIP is real."""
        er = self.embed_images(real_images)
        ef = self.embed_images(fake_images)
        fid = frechet_distance(*gaussian_stats(er), *gaussian_stats(ef))
        return {
            "clip_fid": fid,
            "n_real": int(er.shape[0]),
            "n_fake": int(ef.shape[0]),
            "clip_is_real": self.is_real,
            "mock_reasons": self.mock_reasons,
        }

    def clip_score(self, images, texts: Optional[List[str]] = None,
                   text_embeds=None) -> dict:
        assert exists(texts) ^ exists(text_embeds)
        if not exists(text_embeds):
            with torch.inference_mode():
                text_embeds, _ = self.clip.embed_texts(texts)
        score = clip_score(self.embed_images(images), text_embeds)
        return {
            "clip_score": score,
            "clip_is_real": self.is_real,
            "mock_reasons": self.mock_reasons,
        }
