"""Deterministic synthetic token pipeline.

Copy of ``repro/data/pipeline.py`` (numpy only; the port keeps its own
copy and imports nothing of the reference): a batch is the reference's
batch bit for bit.  Only the launcher moves it to the device.

Produces reproducible (tokens, labels) batches without external data: a
mixture of Zipf-distributed unigrams and short Markov "phrases" so the loss
actually decreases during the example training runs.  Supports per-host
sharding (each data-parallel host pulls only its slice) and stateless
resume: batch i is a pure function of (seed, i), so a restarted job
continues the stream exactly (checkpoint stores only the step counter).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    # synthetic structure
    zipf_a: float = 1.3
    phrase_len: int = 8
    n_phrases: int = 512


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed phrase table (shared structure to learn)
        self.phrases = root.integers(0, v, (cfg.n_phrases, cfg.phrase_len))
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** -cfg.zipf_a
        self.unigram = p / p.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for `step`, local slice for this host. Pure in (seed, step)."""
        cfg = self.cfg
        local = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 64 + cfg.host_id)
        toks = rng.choice(cfg.vocab_size, size=(local, cfg.seq_len + 1),
                          p=self.unigram)
        # splice phrases at random offsets (learnable bigram structure)
        n_splice = max(1, cfg.seq_len // (2 * cfg.phrase_len))
        for b in range(local):
            idx = rng.integers(0, cfg.n_phrases, n_splice)
            off = rng.integers(0, cfg.seq_len - cfg.phrase_len, n_splice)
            for i, o in zip(idx, off):
                toks[b, o:o + cfg.phrase_len] = self.phrases[i]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class SyntheticMasked:
    """Masked-frame batches for encoder-only (hubert-style) training."""

    def __init__(self, cfg: DataConfig, d_model: int, mask_rate: float = 0.3):
        self.cfg = cfg
        self.d_model = d_model
        self.mask_rate = mask_rate
        root = np.random.default_rng(cfg.seed)
        self.codebook = root.normal(size=(cfg.vocab_size, d_model)).astype(np.float32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        local = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(
            (cfg.seed * 999_983 + step) * 64 + cfg.host_id)
        labels = rng.integers(0, cfg.vocab_size, (local, cfg.seq_len))
        embeds = self.codebook[labels] + \
            rng.normal(0, 0.5, (local, cfg.seq_len, self.d_model)).astype(np.float32)
        mask = rng.random((local, cfg.seq_len)) < self.mask_rate
        return {"embeds": embeds.astype(np.float32),
                "labels": labels.astype(np.int32), "mask": mask}
