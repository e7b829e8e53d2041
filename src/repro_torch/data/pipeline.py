"""Deterministic synthetic data pipeline with packing and prefetch.

A copy of ``repro/data/pipeline.py`` (numpy only), so the port imports
nothing of the JAX package: the same seed gives the same batches, bit for
bit.  The batches are numpy arrays; the train step moves them to its
device.  Serves two purposes: (1) CPU-runnable end-to-end training
examples with a *learnable* distribution (affine-recurrence token streams: t_{i+1} =
(a * t_i + c) mod V within documents, so next-token loss can fall well below
the uniform entropy); (2) the input-spec contract for the dry-run (shape and
dtype identical to the real batches).

Per-host sharding: each process materializes only its slice of the global
batch (``host_slice``); a background thread prefetches ``prefetch`` batches.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class SyntheticLM:
    """Packed affine-recurrence documents -> {tokens, labels, loss_mask}."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int, *,
                 seed: int = 0, doc_len_range=(64, 512),
                 process_index: int = 0, process_count: int = 1):
        assert global_batch % process_count == 0
        self.vocab, self.seq = vocab, seq_len
        self.local_batch = global_batch // process_count
        self.rng = np.random.default_rng(seed + 1013 * process_index)
        self.doc_len_range = doc_len_range

    def _doc(self, length: int) -> np.ndarray:
        a = int(self.rng.integers(1, 64)) * 2 + 1  # odd multiplier
        c = int(self.rng.integers(0, self.vocab))
        t = np.empty(length, np.int64)
        t[0] = self.rng.integers(0, self.vocab)
        for i in range(1, length):
            t[i] = (a * t[i - 1] + c) % self.vocab
        return t

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> dict:
        B, S = self.local_batch, self.seq
        toks = np.zeros((B, S + 1), np.int64)
        mask = np.ones((B, S), np.float32)
        for b in range(B):
            pos = 0
            while pos < S + 1:
                L = int(self.rng.integers(*self.doc_len_range))
                d = self._doc(min(L, S + 1 - pos))
                toks[b, pos : pos + len(d)] = d
                if pos > 0:
                    mask[b, pos - 1] = 0.0  # no loss across document boundary
                pos += len(d)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "loss_mask": mask,
        }


class Prefetcher:
    """Background-thread prefetch wrapper around any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        except BaseException as e:  # surfaced on next()
            self._err = e
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise self._err or StopIteration
        return item
