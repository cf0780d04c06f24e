"""The benchmark's own data, made from a seed: images in [0, 1], each its
own tint, a ramp of its own direction and slope, and uniform noise of its
own strength (so that no two samples look alike to D, as no two photos
do), and captions of words drawn from a word list.  Item ``i`` is a
function of (seed, i) alone."""

from __future__ import annotations

import math

import numpy as np


class SeededImages:
    """A map-style dataset of ``length`` images (h, w, 3) float32, with a
    caption each when ``words`` are given."""

    def __init__(self, image_size: int, seed: int, *, length: int = 100_000,
                 words=None, min_words: int = 4, max_words: int = 16):
        self.image_size = image_size
        self.seed = int(seed)
        self.length = length
        self.words = list(words) if words else None
        self.min_words, self.max_words = min_words, max_words

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, int(index)))
        n = self.image_size
        tint = rng.uniform(0.1, 0.9, 3).astype(np.float32)
        theta, slope, amp = (float(v) for v in rng.uniform(
            (0.0, -0.5, 0.05), (2 * np.pi, 0.5, 0.45)))
        axis = np.linspace(-0.5, 0.5, n, dtype=np.float32)
        ramp = (math.cos(theta) * axis[None, :]
                + math.sin(theta) * axis[:, None])
        noise = rng.random((n, n, 3), dtype=np.float32) - 0.5
        image = tint + (slope * ramp)[..., None] + amp * noise
        image = np.clip(image, 0.0, 1.0, out=image)
        if self.words is None:
            return image
        return image, caption(rng, self.words, self.min_words,
                              self.max_words)


def caption(rng, words, min_words: int, max_words: int) -> str:
    n = int(rng.integers(min_words, max_words + 1))
    return " ".join(words[int(i)] for i in rng.integers(0, len(words), n))
