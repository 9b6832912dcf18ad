"""Token batches from the seed: a copy of the port's ``SyntheticDataset``
generator (``data/pipeline.py``: an order-1 Markov chain over the vocabulary
with ``branching`` successors a token and Dirichlet(0.35) transition
weights), drawn by inverse CDF a position at a time for ``BLOCK`` batches at
once, instead of one ``rng.choice`` a token and a batch at a time.  A block
costs tens of milliseconds, once for 64 steps, so the feed's thread does not
hold the interpreter while the step launches its kernels.  Every batch is a
function of (seed, step): its rows differ from step to step and the reference
draws the same ones again."""

from __future__ import annotations

import numpy as np

BLOCK = 64   # batches drawn together


class MarkovFeed:
    """``batch(step) -> {"tokens", "labels"}``, int32 (batch, seq) arrays,
    the labels the tokens shifted by one."""

    def __init__(self, vocab: int, seq: int, batch: int, seed: int, branching: int):
        rng = np.random.default_rng((seed, 0x5EED))
        self.vocab, self.seq, self.batch_size, self.seed = vocab, seq, batch, seed
        self.succ = rng.integers(0, vocab, size=(vocab, branching))
        self.cdf = np.cumsum(rng.dirichlet(np.full(branching, 0.35), size=vocab), axis=1)
        self.blocks: dict = {}

    def _block(self, index: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, index + 1))
        rows = BLOCK * self.batch_size
        out = np.empty((rows, self.seq + 1), np.int64)
        out[:, 0] = rng.integers(0, self.vocab, size=rows)
        u = rng.random((self.seq, rows))
        last = self.succ.shape[1] - 1
        for t in range(self.seq):
            cur = out[:, t]
            choice = (u[t][:, None] > self.cdf[cur]).sum(axis=1).clip(max=last)
            out[:, t + 1] = self.succ[cur, choice]
        return out

    def batch(self, step: int) -> dict:
        index, row = divmod(step, BLOCK)
        if index not in self.blocks:
            self.blocks = {index: self._block(index)}
        rows = self.blocks[index][row * self.batch_size: (row + 1) * self.batch_size]
        return {"tokens": rows[:, :-1].astype(np.int32), "labels": rows[:, 1:].astype(np.int32)}
