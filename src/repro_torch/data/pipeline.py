"""Deterministic synthetic LM data (port of ``repro.data.pipeline``, without
JAX): a seeded Markov-chain token stream with a power-law start
distribution, whose bigram structure a model can learn.  The numpy batches
equal the reference's bit for bit; ``to_device`` takes the place of the
reference's ``device_put_batch``.  The reference's stub-frontend
embeddings (``frontend_len``) are left out: no model config of the port has
a frontend.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    branch: int = 32          # out-degree of the bigram graph


def _bigram_table(vocab: int, branch: int, seed: int) -> np.ndarray:
    """[vocab, branch] int32 successor table (the learnable structure)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(vocab, branch), dtype=np.int32)


def _zipf_start(rng, vocab: int, n: int) -> np.ndarray:
    z = rng.zipf(1.5, size=n).astype(np.int64)
    return (z % vocab).astype(np.int32)


def synthetic_batch(cfg: DataConfig, step: int, *, host_id: int = 0,
                    num_hosts: int = 1) -> dict:
    """Deterministic batch for ``step``; only this host's rows.

    Returns {"tokens": [B_host, S], "labels": [B_host, S]} int32 numpy
    arrays; labels are next-token: labels[t] =
    tokens[t+1]."""
    if cfg.global_batch % num_hosts:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"over {num_hosts} hosts")
    b_host = cfg.global_batch // num_hosts
    table = _bigram_table(cfg.vocab_size, cfg.branch, cfg.seed)
    rng = np.random.default_rng(
        (cfg.seed * 1_000_003 + step) * 131 + host_id)

    tokens = np.empty((b_host, cfg.seq_len + 1), np.int32)
    tokens[:, 0] = _zipf_start(rng, cfg.vocab_size, b_host)
    choices = rng.integers(0, cfg.branch, size=(b_host, cfg.seq_len))
    for t in range(cfg.seq_len):
        tokens[:, t + 1] = table[tokens[:, t], choices[:, t]]

    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:].copy()}


def make_batch_iterator(cfg: DataConfig, *, start_step: int = 0,
                        host_id: int = 0,
                        num_hosts: int = 1) -> Iterator[dict]:
    """Stateless, resumable: iteration i yields the batch for
    ``start_step + i``."""
    step = start_step
    while True:
        yield synthetic_batch(cfg, step, host_id=host_id, num_hosts=num_hosts)
        step += 1


def to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
