"""Deterministic data (the port of ``repro/training/data.py``:
``BatchSpec``, ``SyntheticLM``, ``PackedCorpus``, ``microbatched``).

Batches are generated statelessly from (seed, step, shard) through the
same blake2b-seeded numpy streams as the reference, so both packages draw
the same tokens (and ``PackedCorpus`` the same rows and loss masks) bit
for bit: a restart from a checkpoint resumes the exact token stream.
Batches are numpy arrays; the caller moves them to its device.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

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


class PackedCorpus:
    """Greedy document packing into fixed-length rows.

    Documents are arrays of token ids; rows are built by concatenating
    documents with EOS separators, padding the tail.  The loss mask zeroes
    padding.  Row assignment is stateless in (seed, step, shard).
    """

    def __init__(self, docs, spec: BatchSpec, seed: int = 0,
                 eos: int = 0, pad: int = 0):
        self.docs = [np.asarray(d, np.int32) for d in docs]
        assert self.docs, "empty corpus"
        self.spec, self.seed = spec, seed
        self.eos, self.pad = eos, pad

    def _pack_row(self, rng: np.random.Generator) -> Tuple[np.ndarray,
                                                           np.ndarray]:
        sp = self.spec
        L = sp.seq_len + 1
        row = np.full((L,), self.pad, np.int32)
        mask = np.zeros((L,), np.float32)
        pos = 0
        while pos < L:
            d = self.docs[int(rng.integers(len(self.docs)))]
            take = min(len(d), L - pos)
            row[pos:pos + take] = d[:take]
            mask[pos:pos + take] = 1.0
            pos += take
            if pos < L:
                row[pos] = self.eos
                mask[pos] = 1.0
                pos += 1
        return row, mask

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        sp = self.spec
        rng = _rng_for(self.seed, step, sp.shard)
        rows, masks = zip(*[self._pack_row(rng)
                            for _ in range(sp.local_batch)])
        rows = np.stack(rows)
        masks = np.stack(masks)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:],
                "loss_mask": masks[:, 1:]}

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
