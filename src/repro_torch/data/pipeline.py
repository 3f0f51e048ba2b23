"""Synthetic token data pipeline: deterministic corpus, sequence packing,
sharded batch loading (the reference's ``repro.data.pipeline``).  The
corpus and the loader are the reference's numpy code, so batches are
bitwise the reference's; ``device_batches`` hands them over as tensors.

Real deployments swap `SyntheticCorpus` for a tokenized dataset; the packing
and sharded-loading layers stay."""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticCorpus:
    """Zipf-distributed tokens with short-range structure (bigram mixing) —
    enough signal that training loss actually falls."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** -cfg.zipf_a
        self.p = p / p.sum()
        self.shift = self.rng.integers(1, max(v - 1, 2))

    def documents(self) -> Iterator[np.ndarray]:
        v = self.cfg.vocab_size
        while True:
            n = int(self.rng.integers(32, 4 * self.cfg.seq_len))
            base = self.rng.choice(v, size=n, p=self.p)
            # bigram structure: even positions determine odd ones
            base[1::2] = (base[0::2][:len(base[1::2])] + self.shift) % v
            yield base.astype(np.int32)


class PackedLoader:
    """Packs documents into fixed (global_batch, seq_len+1) examples and
    yields per-shard slices for the data-parallel axis."""

    def __init__(self, cfg: DataConfig, shard_index: int = 0,
                 num_shards: int = 1):
        self.cfg = cfg
        assert cfg.global_batch % num_shards == 0
        self.shard_index = shard_index
        self.num_shards = num_shards
        self._docs = SyntheticCorpus(
            dataclasses.replace(cfg, seed=cfg.seed + shard_index)).documents()
        self._buf = np.zeros((0,), np.int32)

    def _fill(self, n: int) -> np.ndarray:
        while len(self._buf) < n:
            self._buf = np.concatenate([self._buf, next(self._docs)])
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def __iter__(self):
        B = self.cfg.global_batch // self.num_shards
        S = self.cfg.seq_len
        while True:
            flat = self._fill(B * (S + 1))
            ex = flat.reshape(B, S + 1)
            yield {"tokens": ex[:, :-1], "labels": ex[:, 1:]}


def device_batches(loader: PackedLoader, device):
    """The loader's host batches as int32 tensors on ``device``."""
    for batch in loader:
        yield {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
