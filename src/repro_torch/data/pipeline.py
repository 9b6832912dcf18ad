"""Deterministic synthetic LM data pipeline with background prefetch: the
port's own copy of the reference's ``data/pipeline.py`` (numpy only), which
gives the same ``(seed, step)`` stream bit for bit.  Batches are numpy
arrays; the trainer moves them to the model's device.

Offline container => no real corpus; the stream is a seeded sparse Markov
chain over the vocabulary, which has low intrinsic entropy so short training
runs show a *decreasing* loss (quickstart/e2e examples assert this).  Every
batch is a pure function of (seed, step): restart-safe by construction --
resuming from step k reproduces the exact token stream, which is what makes
checkpoint-restart bit-reproducible.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class MarkovLM:
    """Order-1 Markov chain with ``branching`` successors per token."""

    def __init__(self, vocab: int, seed: int = 0, branching: int = 4):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.branching = branching
        # successor table (vocab, branching) + skewed transition probs
        self.succ = rng.integers(0, vocab, size=(vocab, branching))
        p = rng.dirichlet(np.full(branching, 0.35), size=vocab)
        self.probs = p

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq + 1), np.int64)
        out[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(seq):
            cur = out[:, t]
            choice = np.array(
                [rng.choice(self.branching, p=self.probs[c]) for c in cur]
            )
            out[:, t + 1] = self.succ[cur, choice]
        return out


class SyntheticDataset:
    """Deterministic ``batch(step)`` -> {"tokens", "labels"} (next-token)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int, seed: int = 0,
                 extra_specs: dict | None = None):
        self.lm = MarkovLM(vocab, seed)
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.extra_specs = extra_specs or {}

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        toks = self.lm.sample(rng, self.global_batch, self.seq_len)
        out = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        for name, (shape, dtype) in self.extra_specs.items():
            out[name] = (rng.standard_normal(shape) * 0.1).astype(dtype)
        return out


class Prefetcher:
    """Background-thread double buffering: hides host-side batch generation
    behind device compute (the standard input-pipeline overlap trick)."""

    def __init__(self, dataset: SyntheticDataset, start_step: int = 0, depth: int = 2):
        self.dataset = dataset
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.dataset.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict]:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
