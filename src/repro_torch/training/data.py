"""Deterministic synthetic data (the port of ``repro/training/data.py``:
``BatchSpec``, ``SyntheticLM``, ``microbatched``).

Batches are generated statelessly from (seed, step, shard) through the
same blake2b-seeded numpy streams as the reference, so both packages draw
the same tokens bit for bit.  Batches are numpy arrays; the caller moves
them to its device.  ``PackedCorpus`` waits for the training surface
(ROADMAP.md).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


def _rng_for(seed: int, step: int, shard: int) -> np.random.Generator:
    # stable, collision-resistant per-(seed, step, shard) stream
    h = hashlib.blake2b(f"{seed}/{step}/{shard}".encode(), digest_size=8)
    return np.random.default_rng(int.from_bytes(h.digest(), "little"))


@dataclass(frozen=True)
class BatchSpec:
    global_batch: int
    seq_len: int
    vocab_size: int
    n_shards: int = 1      # dp size; batch dim is split across shards
    shard: int = 0

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.n_shards == 0
        return self.global_batch // self.n_shards


class SyntheticLM:
    """Zipf-distributed synthetic LM tokens; (tokens, labels) next-token."""

    def __init__(self, spec: BatchSpec, seed: int = 0, zipf_a: float = 1.2):
        self.spec, self.seed, self.zipf_a = spec, seed, zipf_a

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        sp = self.spec
        rng = _rng_for(self.seed, step, sp.shard)
        v = sp.vocab_size
        toks = rng.zipf(self.zipf_a, size=(sp.local_batch, sp.seq_len + 1))
        toks = np.minimum(toks, v - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def microbatched(batch: Dict[str, np.ndarray], grad_accum: int
                 ) -> Dict[str, np.ndarray]:
    """(B, ...) -> (G, B/G, ...) stream layout for the pipeline step."""
    def rs(x):
        return x.reshape((grad_accum, x.shape[0] // grad_accum)
                         + x.shape[1:])
    return {k: rs(v) for k, v in batch.items()}
