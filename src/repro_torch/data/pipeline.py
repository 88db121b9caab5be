"""Deterministic, host-sharded token pipeline with prefetch.

Each host produces only its shard of the global batch (``host_batch =
global_batch // num_hosts``), keyed by (seed, step, host), so that a
restart resumes bit-exactly from any step without replaying the stream.  A
background thread keeps ``prefetch`` batches ready, overlapping the data
path with compute.

The generator is synthetic but structured: Zipfian unigrams with short
repeated motifs, so that models reduce their loss on it while it needs
nothing from outside.  It is numpy throughout, from the same
``SeedSequence`` as the reference's, so the two packages see the same
batches bit for bit.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    motif_prob: float = 0.5

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.num_hosts} hosts")
        return self.global_batch // self.num_hosts


class TokenStream:
    """Stateless-per-step batch generator and an optional prefetch
    thread."""

    def __init__(self, cfg: DataConfig, prefetch: int = 2):
        self.cfg = cfg
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # Zipf-ish unigram distribution over the vocab (stable across hosts).
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = probs / probs.sum()

    # -- deterministic access ------------------------------------------------

    def batch_at(self, step: int) -> dict:
        """The host's batch for ``step``, numpy int32 (B, S): a pure function
        of (seed, step, host_id)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id])
        )
        b, s = cfg.host_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab, size=(b, s), p=self._probs)
        # Inject repeated motifs (learnable short-range structure).
        n_motifs = max(1, s // (4 * cfg.motif_len))
        for i in range(b):
            if rng.random() < cfg.motif_prob:
                motif = rng.choice(cfg.vocab, size=cfg.motif_len,
                                   p=self._probs)
                for _ in range(n_motifs):
                    at = rng.integers(0, max(1, s - cfg.motif_len))
                    toks[i, at:at + cfg.motif_len] = motif
        return {"tokens": toks.astype(np.int32)}

    # -- prefetching iterator ------------------------------------------------

    def start(self, first_step: int = 0) -> None:
        def worker():
            step = first_step
            while not self._stop.is_set():
                batch = self.batch_at(step)
                while not self._stop.is_set():
                    try:
                        self._queue.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            yield self._queue.get()


def make_batch_specs(cfg: DataConfig) -> dict:
    """The global batch's shapes and dtypes, as tensors on the ``meta``
    device (the reference's ``jax.ShapeDtypeStruct``s)."""
    return {"tokens": torch.empty((cfg.global_batch, cfg.seq_len),
                                  dtype=torch.int32, device="meta")}
