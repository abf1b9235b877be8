"""Carry parameter and cache trees between the JAX package and the port.

A JAX tree here is a nested dict of arrays (``jax.Array`` or numpy; anything
``np.asarray`` takes) with the same keys as the port's trees, which keep the
reference's layouts (stacked ``(L, ...)`` leaves, or unrolled ``layer_{i}``
subtrees; an encoder-decoder's ``encoder`` subtree, its cross-attention
``cross`` leaves and its ``enc_k``/``enc_v`` cache leaves alike, since any
nested dict is carried key for key). This module imports no JAX: it goes through
numpy, so the tests can hand both packages the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_torch", "to_numpy"]


def _leaf_to_torch(a) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":       # ml_dtypes' bf16: reinterpret the bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def to_torch(tree):
    """Nested dict of arrays → nested dict of CPU tensors of the same dtypes."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return _leaf_to_torch(tree)


def to_numpy(tree):
    """Nested dict of tensors → nested dict of numpy arrays (bf16 → float32,
    since numpy has no bf16 of its own)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
