"""Checkpointing: atomic, keep-k (the reference's
``repro.training.checkpoint``, in its on-disk format).

Tensors are copied to the host and written as one .npz per tree per
checkpoint with a JSON manifest (step): ``params.npz``, ``opt.npz``,
``meta.json`` under ``step_XXXXXXXX/``.  npz keys are the leaves' tree
paths joined by ``/`` (dict keys, sequence indices), bfloat16 is written as
float32 (numpy has no bfloat16), so a checkpoint written by either package
restores in the other.  Writes are atomic (tmp + rename), so a crash
mid-save never corrupts the latest checkpoint; ``keep`` old checkpoints are
retained for rollback.

Leaves restore onto the device and dtype of the ``*_like`` tree's.  The
port has no mesh: ``restore``'s ``param_shardings`` / ``opt_shardings``
(the reference's ``NamedSharding`` trees, for an elastic restore onto
another layout) take a ``RankShard``, one rank's place in a tensor-parallel
group: the full checkpoint is read and each leaf sliced on the host to
that rank's shard before it moves to the device, so a rank restores its
shard of a checkpoint written unsharded.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.launch.sharding import shard_tree
from repro_torch.models.convert import tree_map


class RankShard(NamedTuple):
    """Rank ``rank`` of a ``tp``-way group under ``specs``, a tree of
    per-leaf specs (``launch.sharding``, e.g. ``paged_param_specs``) in the
    restored tree's layout."""
    specs: Any
    rank: int
    tp: int


def _paths(tree, prefix=()):
    """(path, leaf) pairs of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _flatten(tree) -> Dict[str, Any]:
    flat = {}
    for path, leaf in _paths(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu")
            arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        else:
            arr = np.asarray(leaf)
        flat[_key(path)] = arr
    return flat


def _unflatten(like, flat: Dict[str, Any], shard=None):
    """``like``'s tree with the checkpoint's arrays at its leaves, as
    tensors on each like leaf's device and dtype; with ``shard`` (a
    ``RankShard``) each array is first sliced on the host to the rank's
    shard."""
    def arrays(t, path):
        if isinstance(t, dict):
            return {k: arrays(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(arrays(v, path + (i,)) for i, v in enumerate(t))
        return flat[_key(path)]

    tree = arrays(like, ())
    if shard is not None:
        if not isinstance(shard, RankShard):
            raise TypeError("restore's shardings take a RankShard (specs, "
                            f"rank, tp), got {type(shard).__name__}")
        tree = shard_tree(tree, shard.specs, shard.rank, shard.tp)

    def place(arr, t):
        if isinstance(t, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(device=t.device,
                                                      dtype=t.dtype)
        return arr
    return tree_map(place, tree, like)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _ckpt_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def save(self, step: int, params, opt_state=None, extra: dict = None):
        tmp = self._ckpt_dir(step) + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "params.npz"), **_flatten(params))
        if opt_state is not None:
            np.savez(os.path.join(tmp, "opt.npz"), **_flatten(opt_state))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **(extra or {})}, f)
        final = self._ckpt_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._ckpt_dir(s), ignore_errors=True)

    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, params_like, opt_like=None,
                param_shardings=None, opt_shardings=None):
        """The checkpoint of ``step`` in the layout, devices and dtypes of
        ``params_like`` / ``opt_like`` (the trees' structure; their leaves'
        shapes are not consulted), each optionally sliced to one rank's
        shard by a ``RankShard``.  Returns (params, opt or None, meta)."""
        d = self._ckpt_dir(step)
        params = _unflatten(params_like,
                            dict(np.load(os.path.join(d, "params.npz"))),
                            param_shardings)
        opt = None
        if opt_like is not None and os.path.exists(os.path.join(d, "opt.npz")):
            opt = _unflatten(opt_like,
                             dict(np.load(os.path.join(d, "opt.npz"))),
                             opt_shardings)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return params, opt, meta
