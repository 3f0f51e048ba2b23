"""Moving parameter and page-pool trees between numpy and torch.

A tree is nested dicts, tuples and lists with arrays or tensors at the
leaves, in the reference's layout (``repro.models.model``).  numpy has no
bfloat16: a bfloat16 array from ``ml_dtypes`` (what the JAX package hands
out) is read through float32, which holds every bfloat16 value exactly,
and a bfloat16 tensor goes to the host as its raw 16-bit pattern
(``int16``), which ``from_host`` restores bit for bit.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf-wise over one tree or several of the same shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


class Leaves(tuple):
    """Several results at one leaf of a tree (told apart from the tree's
    own tuples), for ``tree_unzip``."""


def tree_unzip(tree, n: int) -> tuple:
    """n trees from one whose leaves are ``Leaves`` of n items."""
    def pick(t, i):
        if isinstance(t, Leaves):
            return t[i]
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        return type(t)(pick(v, i) for v in t)
    return tuple(pick(tree, i) for i in range(n))


def _tensor(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.array(a)                       # a private, writable copy
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
        dtype = dtype or torch.bfloat16
    t = torch.from_numpy(a).to(device)
    return t if dtype is None else t.to(dtype)


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None):
    """A numpy parameter tree (e.g. ``jax.tree.map(np.asarray, params)``)
    as tensors on ``device``, cast to ``dtype`` when given."""
    return tree_map(lambda a: _tensor(a, device, dtype), tree)


def pages_from_numpy(tree, device, dtype: Optional[torch.dtype] = None):
    """A numpy page-pool tree as tensors on ``device``; same layout."""
    return params_from_numpy(tree, device, dtype)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bfloat16 as its 16-bit patterns."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def from_host(a, like: torch.Tensor) -> torch.Tensor:
    """Inverse of ``to_host`` onto ``like``'s device and dtype."""
    a = np.asarray(a)
    if like.dtype == torch.bfloat16 and a.dtype == np.int16:
        return torch.from_numpy(np.array(a)).view(
            torch.bfloat16).to(like.device)
    return _tensor(a, like.device, like.dtype)
