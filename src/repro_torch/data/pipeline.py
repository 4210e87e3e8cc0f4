"""Data pipeline backed by the SAGE object store.

The corpus lives as token-block objects in a Clovis container (striped on
the flash tier — the ingest path for 'massive data sources').  The loader
reads ahead through a StreamContext (prefetch decoupled from the train
step, same pattern as the paper's I/O offload) and yields fixed-shape
batches.  A synthetic corpus generator stands in for external instrument
feeds; everything downstream (objects, layouts, HSM) is the real stack.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core import layouts as lay
from repro_torch.core.clovis import Clovis

CORPUS_CONTAINER = "corpus"


def build_synthetic_corpus(clovis: Clovis, *, vocab: int, n_shards: int = 8,
                           tokens_per_shard: int = 65536, seed: int = 0,
                           noise: float = 0.15) -> int:
    """Write a token corpus into the store; returns total tokens.

    Tokens follow a first-order Markov chain over a small state subset
    (successor ``(t * 7 + 3) % K`` with probability ``1 - noise``,
    uniform over the full vocab otherwise): i.i.d. uniform tokens have no
    learnable structure at all — cross-entropy is pinned at ln(vocab) and
    any train-reduces-loss check can only pass by memorising the corpus —
    whereas a skewed marginal plus a low-entropy transition rule gives
    the model a real signal, like the instrument feeds it stands in for.
    """
    rng = np.random.default_rng(seed)
    K = max(2, min(64, vocab))
    total = 0
    for s in range(n_shards):
        toks = np.empty(tokens_per_shard, dtype=np.int32)
        toks[0] = rng.integers(0, K)
        noisy = rng.random(tokens_per_shard) < noise
        rand = rng.integers(0, vocab, size=tokens_per_shard, dtype=np.int32)
        for i in range(1, tokens_per_shard):
            toks[i] = rand[i] if noisy[i] else (toks[i - 1] * 7 + 3) % K
        oid = f"corpus/shard{s:04d}"
        if not clovis.exists(oid):
            clovis.put_array(oid, toks, container=CORPUS_CONTAINER,
                             layout=lay.DEFAULT_LAYOUTS["data"])
        total += tokens_per_shard
    return total


class TokenLoader:
    """Sharded, prefetching batch iterator over corpus objects.

    ``host_id``/``n_hosts`` split shards for multi-host data parallelism;
    ``start_step`` makes restarts deterministic (shard cursor is derived
    from the step counter, so a restored run resumes the same stream).
    """

    def __init__(self, clovis: Clovis, *, batch: int, seq: int,
                 host_id: int = 0, n_hosts: int = 1, prefetch: int = 4,
                 start_step: int = 0, seed: int = 0):
        self.clovis = clovis
        self.batch, self.seq = batch, seq
        self.shards = [oid for i, oid in
                       enumerate(sorted(clovis.container(CORPUS_CONTAINER)))
                       if i % n_hosts == host_id]
        if not self.shards:
            raise ValueError("empty corpus for this host")
        self.step = start_step
        self.seed = seed
        self._q: "queue.Queue[Dict]" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _tokens_for_step(self, step: int) -> np.ndarray:
        need = self.batch * (self.seq + 1)
        rng = np.random.default_rng(self.seed + step)
        out = np.empty(need, np.int32)
        got = 0
        while got < need:
            oid = self.shards[rng.integers(len(self.shards))]
            arr = self.clovis.get_array(oid)
            take = min(need - got, arr.size)
            off = int(rng.integers(max(arr.size - take, 1)))
            out[got: got + take] = arr[off: off + take]
            got += take
        return out

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            toks = self._tokens_for_step(step).reshape(
                self.batch, self.seq + 1)
            batch = {"tokens": toks[:, :-1].copy(),
                     "labels": toks[:, 1:].copy()}
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.25)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        step, batch = self._q.get()
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
