"""Serving-time token sampling keyed by (request, position) (port of
`repro.serve.sampling`, DESIGN.md §14).

Greedy (temperature 0) is argmax, identical to the reference. A
non-greedy draw is a Gumbel-max over the top-k / top-p filtered logits
whose uniforms are a counter-based hash of (seed, rid, pos, token id):
a request draws the same tokens whether it runs alone, shares the batch,
or is preempted and re-prefilled. The reference keys jax `fold_in`, which
torch cannot replay, so the port keeps that property, not its bits.
"""
from __future__ import annotations

import dataclasses

import torch

_M32 = 0xFFFFFFFF
# the value a masked logit takes
NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature 0 => greedy; top_k 0 => off; top_p 1.0 => off; `seed`
    roots every (rid, pos) stream."""
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams(temperature=0.0)


def _fmix(h: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche mix on int64 tensors holding uint32 values (the
    multipliers stay below 2^31, so no product overflows int64)."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x1B873593) & _M32
    return h ^ (h >> 16)


def lane_uniforms(seed: int, rids: torch.Tensor, poss: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """U(0,1) [B, V]: a pure function of (seed, rid[b], pos[b], token)."""
    dev = rids.device
    key = _fmix(torch.full_like(rids, int(seed) & _M32, dtype=torch.int64))
    key = _fmix(key ^ (rids.to(torch.int64) & _M32))
    key = _fmix(key ^ (poss.to(torch.int64) & _M32))
    tok = torch.arange(vocab, dtype=torch.int64, device=dev)
    h = _fmix(key[:, None] ^ _fmix(tok)[None, :])
    return ((h >> 8).to(torch.float64) + 0.5) / float(1 << 24)


def _mask_top_k(logits, k: int):
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits, NEG_INF)


def _mask_top_p(logits, p: float):
    if p >= 1.0:
        return logits
    srt = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p
    thr = torch.where(keep, srt, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where(logits >= thr, logits, NEG_INF)


def sample_tokens(logits: torch.Tensor, rids, poss,
                  sp: SamplingParams) -> torch.Tensor:
    """Batched draw: logits [B, V], rids [B], poss [B] -> int32 [B]. Lane
    b's token depends only on (logits[b], rid[b], pos[b], sp); negative
    rids (free lanes) draw a discarded token."""
    if sp.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    rids = torch.as_tensor(rids, device=logits.device).clamp(min=0)
    poss = torch.as_tensor(poss, device=logits.device)
    x = logits.to(torch.float32)
    x = _mask_top_p(_mask_top_k(x, sp.top_k), sp.top_p)
    u = lane_uniforms(sp.seed, rids, poss, x.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(x.to(torch.float64) / sp.temperature + gumbel,
                        dim=-1).to(torch.int32)
