"""Sharded, restartable input pipeline.

Counterpart of ``repro.data.pipeline``. Deterministic: batch t is a pure
function of (seed, t), so restart-after-failure resumes by skipping to the
right step (no data replay / skew). Batches are int32 tensors on the
pipeline's device (CUDA unless the caller names one; without a GPU the
default raises, as ``core.additive_gp.resolve_device`` does); with a
``sharding`` (one ``distributed.sharding.Sharding`` or a dict of them, e.g.
from ``batch_pspecs``) each batch is placed on its mesh as DTensors, every
rank holding its slice of the global batch.
"""
from __future__ import annotations

from typing import Iterator

import torch

from ..core.additive_gp import resolve_device
from .synthetic import token_stream

__all__ = ["ShardedBatches"]


class ShardedBatches:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, start_step: int = 0, sharding=None,
                 device=None):
        self.device = resolve_device(device)
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.step = 0
        self.sharding = sharding
        self._gen = token_stream(vocab, seq_len, global_batch, seed)
        for _ in range(start_step):  # deterministic skip on resume
            next(self._gen)
            self.step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        toks, labels = next(self._gen)
        self.step += 1
        batch = {"tokens": torch.from_numpy(toks).to(self.device),
                 "labels": torch.from_numpy(labels).to(self.device)}
        if self.sharding is not None:
            from ..distributed.sharding import device_put

            batch = device_put(batch, self.sharding)
        return batch
