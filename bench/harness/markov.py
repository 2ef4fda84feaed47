"""Markov token batches: a frozen copy of the "markov" kind of
`src/repro_torch/data/pipeline.py` (`_generator`, `SyntheticLM`), so the
program cannot move the training data.

Every batch is a pure function of (seed, step), drawn on the host from a
seeded `torch.Generator`: a fixed random bigram chain over the first
`min(vocab, 1024)` ids, 4 likely successors per token and 5% noise, so
every row of every step differs and the loss falls. The draws are the
original's; the chain is walked in numpy (the same values, a few times
faster than the original's loop of torch ops).
"""
from __future__ import annotations

import numpy as np
import torch


def _generator(seed: int, step: int) -> torch.Generator:
    return torch.Generator().manual_seed(
        (int(seed) * 0x9E3779B1 + int(step)) & 0x7FFFFFFFFFFFFFFF)


class MarkovLM:
    """batch(step) -> {"tokens" [B, S], "labels" [B, S]} on `device`:
    inputs t[:-1] and labels t[1:] of a [B, S + 1] chain sample."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int, seed: int,
                 device="cpu"):
        self.seq_len = seq_len + 1
        self.batch_size = batch
        self.seed = seed
        self.device = device
        self.chain_vocab = min(vocab_size, 1024)
        self._succ = torch.randint(0, self.chain_vocab,
                                   (self.chain_vocab, 4),
                                   generator=_generator(seed ^ 0xDA7A, 0))

    def tokens(self, step: int) -> torch.Tensor:
        gen = _generator(self.seed, step)
        B, S, cv = self.batch_size, self.seq_len, self.chain_vocab
        tok = torch.randint(0, cv, (B,), generator=gen).numpy()
        choices = torch.randint(0, 4, (B, S), generator=gen).numpy()
        noise = (torch.rand((B, S), generator=gen) < 0.05).numpy()
        rand_tok = torch.randint(0, cv, (B, S), generator=gen).numpy()
        succ = self._succ.numpy()
        out = np.empty((B, S), dtype=np.int64)
        for s in range(S):
            tok = np.where(noise[:, s], rand_tok[:, s],
                           succ[tok, choices[:, s]])
            out[:, s] = tok
        return torch.from_numpy(out)

    def batch(self, step: int) -> dict:
        t = self.tokens(step).to(self.device)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}
