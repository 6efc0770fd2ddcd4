"""Data pipeline — deterministic synthetic LM stream + host-side prefetch.

The port of the JAX package's ``data/pipeline.py``, in numpy, token for
token: ``batch(step)`` is a pure function of (seed, step), so a restarted
job resumes mid-epoch on the same stream, and each data-parallel process
slices the same global batch by its rank without coordination
(``torch.distributed`` when it is initialised, else one process).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class Batch:
    ids: np.ndarray          # [B, S] int32
    labels: np.ndarray       # [B, S] int32 (next-token targets)
    mask: np.ndarray         # [B, S] float32


class SyntheticLMData:
    """Structured synthetic tokens (repeating n-gram motifs + noise).

    Motif structure gives a learnable signal, so a short run shows a
    *decreasing* loss, unlike iid-uniform tokens.
    """

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, motif_len: int = 8, n_motifs: int = 64,
                 noise: float = 0.05):
        self.vocab, self.seq_len, self.global_batch = vocab, seq_len, global_batch
        self.seed, self.noise = seed, noise
        rng = np.random.default_rng(seed)
        self.motifs = rng.integers(0, vocab, (n_motifs, motif_len), dtype=np.int32)

    # -- multi-process slicing ---------------------------------------------- #
    def local_slice(self) -> tuple[int, int]:
        import torch.distributed as dist

        n, i = ((dist.get_world_size(), dist.get_rank())
                if dist.is_available() and dist.is_initialized() else (1, 0))
        per = self.global_batch // n
        return i * per, per

    def batch(self, step: int, local_only: bool = False) -> Batch:
        rng = np.random.default_rng((self.seed, step))
        start, per = self.local_slice() if local_only else (0, self.global_batch)
        m_len = self.motifs.shape[1]
        reps = self.seq_len // m_len + 2
        idx = rng.integers(0, len(self.motifs), (per, reps))
        toks = self.motifs[idx].reshape(per, -1)[:, :self.seq_len + 1]
        flip = rng.random(toks.shape) < self.noise
        toks = np.where(flip, rng.integers(0, self.vocab, toks.shape), toks)
        toks = toks.astype(np.int32)
        return Batch(ids=toks[:, :-1], labels=toks[:, 1:],
                     mask=np.ones((per, self.seq_len), np.float32))

    def __iter__(self) -> Iterator[Batch]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class PrefetchIterator:
    """Background-thread prefetch (depth-bounded), overlapping host data
    generation with device compute."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for x in self._it:
                self._q.put(x)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        x = self._q.get()
        if x is self._done:
            raise StopIteration
        return x
