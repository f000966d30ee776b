"""Image -> token-sequence views for the attention classifier, numpy
only: a copy of ``idc_models_tpu/data/sequences.py``, so the same images
give the same sequences in both packages.

Each decoded patch becomes a raster-order sequence of square
sub-patches, every token the flattened pixels of one sub-patch
(ViT-style patch embedding, minus the learned projection -- that is the
model's `embed` layer). ``patch_size=1`` degenerates to the per-pixel
sequence (S*S tokens of the 3 channel values).
"""

from __future__ import annotations

import numpy as np


def patchify(images: np.ndarray, patch_size: int) -> np.ndarray:
    """[N, S, S, C] images -> [N, (S/p)^2, p*p*C] token sequences.

    Tokens are the p x p sub-patches in raster order; each token's
    features are its pixels flattened row-major with channels innermost.
    `S` must divide by `patch_size` (images are already square-resized
    by the loaders).
    """
    if patch_size < 1:
        raise ValueError(f"patch_size must be >= 1, got {patch_size}")
    images = np.asarray(images)
    if images.ndim != 4 or images.shape[1] != images.shape[2]:
        raise ValueError(f"expected [N, S, S, C] images, got "
                         f"{images.shape}")
    n, s, _, c = images.shape
    if s % patch_size:
        raise ValueError(f"image size {s} not divisible by patch_size "
                         f"{patch_size}")
    g = s // patch_size
    x = images.reshape(n, g, patch_size, g, patch_size, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)          # [N, gy, gx, p, p, C]
    return np.ascontiguousarray(
        x.reshape(n, g * g, patch_size * patch_size * c))


def sequence_shape(image_size: int, patch_size: int,
                   channels: int = 3) -> tuple[int, int]:
    """(seq_len, features) of `patchify` output for planning/validation."""
    if patch_size < 1:
        raise ValueError(f"patch_size must be >= 1, got {patch_size}")
    if image_size % patch_size:
        raise ValueError(f"image size {image_size} not divisible by "
                         f"patch_size {patch_size}")
    g = image_size // patch_size
    return g * g, patch_size * patch_size * channels
