"""Deterministic synthetic LM data (port of `repro.data.pipeline`).

Every batch is a pure function of (seed, step), drawn on the host from a
seeded `torch.Generator` and moved to the device, so a run resumes at any
step with no pipeline state. The draws differ from the reference's jax
ones; tests that compare the two packages hand both the reference's batch
as numpy.

  * "uniform": i.i.d. tokens, for shape and dry-run checks;
  * "markov": tokens from a fixed random bigram chain (4 likely successors
    per token, 5% noise), so training losses actually fall.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


def _generator(seed: int, step: int) -> torch.Generator:
    return torch.Generator().manual_seed(
        (int(seed) * 0x9E3779B1 + int(step)) & 0x7FFFFFFFFFFFFFFF)


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, kind: str = "markov",
                 chain_vocab: Optional[int] = None, device=None):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.kind = kind
        self.device = resolve_device(device)
        cv = chain_vocab or min(vocab_size, 1024)
        self.chain_vocab = cv
        self._succ = torch.randint(0, cv, (cv, 4),
                                   generator=_generator(seed ^ 0xDA7A, 0))

    def _markov(self, gen: torch.Generator) -> torch.Tensor:
        B, S, cv = self.global_batch, self.seq_len, self.chain_vocab
        tok = torch.randint(0, cv, (B,), generator=gen)
        choices = torch.randint(0, 4, (B, S), generator=gen)
        noise = torch.rand((B, S), generator=gen) < 0.05
        rand_tok = torch.randint(0, cv, (B, S), generator=gen)
        out = torch.empty((B, S), dtype=torch.int64)
        for s in range(S):
            tok = torch.where(noise[:, s], rand_tok[:, s],
                              self._succ[tok, choices[:, s]])
            out[:, s] = tok
        return out

    def tokens(self, step: int) -> torch.Tensor:
        gen = _generator(self.seed, step)
        if self.kind == "markov":
            t = self._markov(gen)
        else:
            t = torch.randint(0, self.vocab_size,
                              (self.global_batch, self.seq_len),
                              generator=gen)
        return t.to(self.device)

    def batch(self, step: int) -> dict:
        """Next-token-prediction batch: inputs t[:-1], labels t[1:]."""
        t = self.tokens(step)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def batch_for_arch(arch: ArchConfig, batch_size: int, seq_len: int,
                   step: int = 0, seed: int = 0, kind: str = "uniform",
                   device=None) -> dict:
    """A train batch matching the arch's input kind, on `device` (the CUDA
    device by default): "embeds" [B,S,D] f32 normals for an embeddings
    arch (the stub frontend's output), else "tokens" [B,S] ([B,S,K] with
    K codebooks); "labels" [B,S], or [B,S,K] with K codebooks. "markov"
    applies to single-codebook token input."""
    dev = resolve_device(device)
    K = arch.n_codebooks
    if kind == "markov" and arch.input_kind == "tokens" and K == 1:
        return SyntheticLM(arch.vocab_size, seq_len + 1, batch_size, seed,
                           device=dev).batch(step)
    gen = _generator(seed, step)
    shape = (batch_size, seq_len) + ((K,) if K > 1 else ())
    b = {}
    if arch.input_kind == "embeddings":
        b["embeds"] = torch.randn((batch_size, seq_len, arch.d_model),
                                  generator=gen)
    else:
        b["tokens"] = torch.randint(0, arch.vocab_size, shape, generator=gen)
    b["labels"] = torch.randint(0, arch.vocab_size, shape, generator=gen)
    return {k: v.to(dev) for k, v in b.items()}
