"""Continuous-batching serving engine with disaggregated stages and a
paged BFP KV cache (port of `repro.serve.engine`, DESIGN.md §14).

The port runs on one device (`device=None` is the CUDA device; pass
"cpu" to run on the CPU) and updates the KV cache in place; the
scheduling, paging, preemption and metrics are the reference's. Where
the reference jits its stages, the port runs prefill and extend eagerly
and, on the CUDA device, captures the generate tick once as a CUDA graph
(`serve/graph.py`) that every later tick replays; `cuda_graph=False`
keeps the tick eager, so the card can hold the graph against it. The
CPU always runs the tick eagerly, through the same static buffers.

The engine is organized JetStream-style around three separately
benchmarkable stages:

  * **prefill** — prompt → prefix cache + first-token logits. Short
    prompts take the one-shot `models.prefill`; long prompts run
    **chunked**: the prompt streams through the multi-token decode step
    into a B=1 prefix slab in `prefill_chunk`-token chunks, so with
    `async_prefill=True` each engine tick advances one chunk AND one
    batched decode step — a long prompt never stalls in-flight decodes
    for its full prefill latency.
  * **insert** — scatter the prefix cache into a free decode lane. One
    write of the whole lane capacity, so a reused lane can never leak its
    previous tenant's KV tail. Slab lanes take a lane-slice write; paged
    lanes a page-table scatter (serve/paged_cache).
  * **generate** — one batched decode step over all lanes, then sampling:
    every draw is keyed by (request id, position)
    (serve/sampling), so outputs are reproducible regardless of which
    requests share the batch. Its shapes are static: lane count, [B,1]
    tokens, lane capacity and page table are fixed at construction, and
    step() copies each tick's tokens, positions and request ids into
    fixed buffers, so one captured graph serves every tick.

KV storage is a **paged pool** by default (`paged=None` → auto, on for
every arch with a KV cache): fixed-size token pages in a shared pool +
per-lane page tables, allocated on demand as a lane's sequence grows and
freed (and zeroed) at completion — pool memory scales with live tokens,
not `max_batch × ctx_len` worst case. `page_size` aligns to the BFP
exponent-block size so a quantized page carries mantissas + shared
exponents as one relocatable unit. When the pool runs dry the engine
**preempts** the youngest active lane (its pages are freed; the request
re-queues at the FRONT of the FIFO and later resumes by re-prefilling
prompt + generated-so-far — sampling keys make the recomputed tokens
identical). Paged decode is bit-identical to the dense slab engine
(`paged=False`) by construction; tests/test_torch_serve.py pins it.

The engine serves token input: an arch with input_kind "embeddings"
(qwen2-vl, musicgen) is refused at construction, as the reference's
engine builds token batches only; those archs serve through the
serve-step stages (`train/serve_step.py`).

Weights are the narrow-BFP serving copy (paper §4.2: 8-bit mantissa
weights at inference), narrowed at construction; `narrowed=True` takes
params that already are `narrow_serving_params(params, arch, hbfp)` as
they are, so several engines share one copy (an arctic-480b layer's
experts are 27 GB). With arch.bfp_kv_cache the pages store 8-bit BFP
K/V. Observability as before (DESIGN.md §12) plus: "serve/prefill" /
"serve/insert" spans, "serve/preempt" events, page-pool gauges, and a
bounded `request_stats` (stats_cap most-recent completions are kept;
`serve_stats_dropped_total` counts evictions).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import check_on, resolve_device
from repro_torch.models import decode_step, lane_capacity, make_cache, \
    make_paged_cache, prefill
from repro_torch.obs import NULL_RECORDER, MetricsRegistry
from repro_torch.serve.graph import GraphedStage
from repro_torch.serve.paged_cache import (PagePool, clear_pages,
                                           insert_prefix, pages_needed,
                                           set_page_table)
from repro_torch.serve.sampling import GREEDY, SamplingParams, sample_tokens
from repro_torch.train.serve_step import (_serve_cfg, _serve_ctx,
                                          narrow_serving_params,
                                          prefill_to_decode_cache)


@dataclasses.dataclass
class _Req:
    rid: int
    pos: int                 # next position to generate
    remaining: int
    tokens: List[int]        # every token generated so far (survives resume)
    prompt: List[int] = dataclasses.field(default_factory=list)  # original
    t_submit: float = 0.0    # recorder-clock perf() at submit()
    t_first: float = 0.0     # ... at first generated token (TTFT end)


def _default_page_size(cfg, C: int) -> int:
    """Align pages to the BFP exponent-block size when it divides the lane
    capacity; otherwise the largest power-of-two page ≤ 16 that does."""
    if cfg is not None:
        b = getattr(cfg, "block_size", None)
        if isinstance(b, int) and b > 0 and C % b == 0:
            return b
    return next(p for p in (16, 8, 4, 2, 1) if C % p == 0)


class ServeEngine:
    def __init__(self, arch: ArchConfig, params, hbfp,
                 *, max_batch: int = 8, ctx_len: int = 512,
                 eos_id: Optional[int] = None, greedy: bool = True,
                 seed: int = 0, recorder=None, metrics=None,
                 paged: Optional[bool] = None,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 async_prefill: bool = False,
                 sampling: Optional[SamplingParams] = None,
                 stats_cap: int = 4096, device=None,
                 cuda_graph: Optional[bool] = None,
                 narrowed: bool = False):
        if arch.input_kind != "tokens":
            raise NotImplementedError(
                f"{arch.name}: the engine serves token input only, as the "
                f"reference's does (its stages feed back sampled tokens); "
                f"serve an input_kind={arch.input_kind!r} arch through the "
                f"serve-step stages (train/serve_step.py: make_prefill_fn, "
                f"make_decode_fn), with the frontend supplying each "
                f"frame's embeddings")
        self.arch = arch
        self.device = resolve_device(device)
        on_cuda = self.device.type == "cuda"
        if cuda_graph and not on_cuda:
            raise ValueError(f"cuda_graph needs the CUDA device, not "
                             f"{self.device}")
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        if self.recorder.enabled and self.recorder.sync_fn is None \
                and self.device.type == "cuda":
            self.recorder.sync_fn = lambda _: torch.cuda.synchronize(
                self.device)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_queue = self.metrics.gauge(
            "serve_queue_depth", "requests waiting for a lane")
        self._m_lanes = self.metrics.gauge(
            "serve_active_lanes", "lanes occupied by a live request")
        self._m_admitted = self.metrics.counter(
            "serve_requests_total", "requests admitted into a lane")
        self._m_done = self.metrics.counter(
            "serve_completions_total", "requests completed")
        self._m_tokens = self.metrics.counter(
            "serve_tokens_total", "tokens generated (prefill firsts incl.)")
        self._m_ttft = self.metrics.histogram(
            "serve_ttft_seconds", "submit-to-first-token latency")
        self._m_preempt = self.metrics.counter(
            "serve_preemptions_total", "lanes evicted on page exhaustion")
        self._m_stats_dropped = self.metrics.counter(
            "serve_stats_dropped_total",
            "completed-request stat records evicted by stats_cap")
        self._m_pages = self.metrics.gauge(
            "serve_pages_used", "page-pool pages currently allocated")
        self._m_occ = self.metrics.gauge(
            "serve_page_occupancy", "page-pool occupancy fraction")
        # {rid: {ttft_s, tokens, dur_s, tok_per_s}} — filled at completion,
        # bounded: the stats_cap most recent completions are retained
        self.request_stats: Dict[int, dict] = {}
        if stats_cap < 1:
            raise ValueError(f"stats_cap must be >= 1, got {stats_cap}")
        self.stats_cap = int(stats_cap)
        self._t_submit: Dict[int, float] = {}
        self.hbfp = _serve_cfg(hbfp)
        check_on(params["head_w"], self.device, "params")
        self.params = params if narrowed else \
            narrow_serving_params(params, arch, hbfp)
        self.max_batch = max_batch
        self.ctx_len = ctx_len
        self.C = lane_capacity(arch, ctx_len)
        self.eos_id = eos_id
        self.greedy = greedy
        self.sampling = sampling if sampling is not None else (
            GREEDY if greedy else SamplingParams(seed=seed))
        self.prefill_chunk = prefill_chunk
        self.async_prefill = bool(async_prefill)
        # the policy's in-graph slice (role widths + backend included)
        self._ctx = _serve_ctx(arch, hbfp, self.device)(None)

        self.paged = (not arch.xlstm) if paged is None else bool(paged)
        if self.paged and arch.xlstm:
            raise ValueError("xlstm archs have no KV cache to page")
        if self.paged:
            self.page_size = page_size if page_size is not None else \
                _default_page_size(self.hbfp, self.C)
            if self.C % self.page_size:
                raise ValueError(f"page_size {self.page_size} must divide "
                                 f"lane capacity {self.C}")
            self.NP = self.C // self.page_size
            self.n_pages = n_pages if n_pages is not None else \
                max_batch * self.NP
            self.pool = PagePool(self.n_pages, self.page_size)
            self._pt = np.full((max_batch, self.NP), -1, np.int32)
            self.cache = make_paged_cache(self.params, arch, max_batch,
                                          ctx_len, self.n_pages,
                                          self.page_size)
        else:
            self.pool = None
            self.cache = make_cache(self.params, arch, max_batch, ctx_len)

        self.slots: List[Optional[_Req]] = [None] * max_batch
        # overload queue: (rid, prompt, max_new_tokens), drained in step().
        # Preempted requests re-enter at the FRONT with prompt extended by
        # their generated tokens (resume state lives in _resume).
        self.pending: Deque[Tuple[int, List[int], int]] = collections.deque()
        self._resume: Dict[int, _Req] = {}
        # requests complete at admission (max_new_tokens=1 / instant EOS):
        # they never occupy a lane; the next step() (or drain()) delivers
        # and clears them, so a step()-polling consumer sees every request
        self._finished: Dict[int, List[int]] = {}
        self._next_rid = 0
        # the generate tick's static inputs: step() copies each tick's
        # positions and request ids in (one copy from pinned memory, so
        # the tick's one host sync stays its output's) and the next
        # tokens back into _tok
        self._tok = torch.zeros((max_batch, 1), dtype=torch.int32,
                                device=self.device)
        self._lanes_host = torch.zeros((2, max_batch), dtype=torch.int32,
                                       pin_memory=on_cuda)
        self._lanes = torch.zeros((2, max_batch), dtype=torch.int32,
                                  device=self.device)
        self._pos = self._lanes[0, :, None]          # [B, 1]
        self._rids = self._lanes[1]                  # [B]
        # the last tick's logits [B, 1, V]; under the graph a static
        # output, overwritten by the next tick
        self.tick_logits: Optional[torch.Tensor] = None
        graphed = on_cuda if cuda_graph is None else bool(cuda_graph)
        self._tick = GraphedStage(self._generate_tick) if graphed \
            else self._generate_tick
        # async chunked-prefill in flight (at most one): dict with rid,
        # lane (reserved), prompt, mnt, pf (prefix slab), next (tokens
        # consumed), cs (chunk), oneshot, page_ids
        self._inflight: Optional[dict] = None
        self._reserved: Optional[int] = None

    def _ints(self, values) -> torch.Tensor:
        return torch.as_tensor(values, dtype=torch.int32, device=self.device)

    # -- stage bodies -----------------------------------------------------
    def _prefill(self, params, tokens, plen):
        """One-shot prefill stage: prompt → (logits, prefix cache)."""
        pos = torch.arange(plen, dtype=torch.int32,
                           device=self.device)[None]
        return prefill(params, {"tokens": tokens, "positions": pos},
                       self.arch, self._ctx, std_pos=False)

    def _extend(self, params, tokens, pos, pf_cache):
        """Chunked-prefill extension stage: a multi-token decode step that
        appends `tokens` into the B=1 prefix slab (ring slots pos % C) and
        returns logits for every chunk position."""
        batch = {"tokens": tokens, "positions": pos}
        return decode_step(params, batch, pf_cache, self.arch, self._ctx)

    def _generate(self, params, cache, tok, pos, rids):
        """Batched decode tick, then sampling: the token entering lane b
        sits at position pos[b]+1 and is drawn with the (rid, pos+1) key —
        free lanes (rid -1) produce discarded draws. Returns (next tokens
        [B], logits [B, 1, V], cache)."""
        batch = {"tokens": tok, "positions": pos}
        logits, cache = decode_step(params, batch, cache, self.arch,
                                    self._ctx)
        nxt = sample_tokens(logits[:, 0], rids, pos[:, 0] + 1, self.sampling)
        return nxt, logits, cache

    def _generate_tick(self) -> torch.Tensor:
        """The generate stage on the static tick buffers and the cache,
        which it updates in place: what the CUDA graph captures."""
        nxt, self.tick_logits, self.cache = self._generate(
            self.params, self.cache, self._tok, self._pos, self._rids)
        return nxt

    def _prefix_slab(self):
        """A fresh B=1 full-capacity prefix slab for chunked prefill (the
        extension stage writes it in place, so it is never shared)."""
        return make_cache(self.params, self.arch, 1, self.ctx_len)

    # -- paged-pool bookkeeping -------------------------------------------

    def _page_gauges(self):
        if self.paged:
            self._m_pages.set(self.pool.used_pages)
            self._m_occ.set(self.pool.occupancy())

    def _release(self, lane: int, rid: int):
        """Free (and zero) a finished/preempted request's pages."""
        if not self.paged:
            return
        ids = self.pool.free(rid)
        if ids:
            self.cache = clear_pages(self.cache, ids)
        self._pt[lane] = -1
        self.cache = set_page_table(self.cache, self._pt)
        self._page_gauges()

    def _preempt_lane(self, lane: int) -> None:
        """Evict one active lane: free (and zero) its pages and re-queue
        the request at the FRONT of the FIFO with resume state — on
        re-admission it re-prefills prompt + generated-so-far and its
        sampling keys reproduce the same continuation."""
        s = self.slots[lane]
        self.slots[lane] = None
        self._resume[s.rid] = s
        self.pending.appendleft((s.rid, s.prompt + s.tokens, s.remaining))
        ids = self.pool.free(s.rid)
        if ids:
            self.cache = clear_pages(self.cache, ids)
        self._pt[lane] = -1
        self._m_preempt.inc()
        self._m_queue.set(len(self.pending))
        self.recorder.emit("serve/preempt", rid=s.rid, lane=lane,
                           generated=len(s.tokens),
                           freed_pages=len(ids))

    def _ensure_pages(self):
        """Allocate each active lane's next-slot page before the decode
        tick, oldest request first; on exhaustion the YOUNGEST active lane
        is preempted — possibly the requester itself (strict oldest-wins
        FIFO: an older lane is never evicted for a younger one's page)."""
        changed = False
        order = sorted((i for i, s in enumerate(self.slots) if s),
                       key=lambda i: self.slots[i].rid)
        for i in order:
            s = self.slots[i]
            if s is None:       # preempted earlier in this pass
                continue
            pidx = (s.pos % self.C) // self.page_size
            if self._pt[i, pidx] >= 0:
                continue
            while True:
                got = self.pool.alloc(s.rid, 1)
                if got is not None:
                    self._pt[i, pidx] = got[0]
                    changed = True
                    break
                active = [j for j, t in enumerate(self.slots)
                          if t is not None]
                victim = max(active, key=lambda j: self.slots[j].rid)
                self._preempt_lane(victim)
                changed = True
                if victim == i:
                    break       # self-evicted; re-queued at the front
        if changed:
            self.cache = set_page_table(self.cache, self._pt)
            self._page_gauges()

    # -- admission --------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 32) -> int:
        """Admit a request into a free lane, or enqueue it (FIFO) when all
        lanes are busy — step() drains the queue as lanes free. Returns rid
        immediately in both cases. With async_prefill the request always
        queues; step() interleaves its prefill chunks with decode ticks."""
        if len(prompt) >= self.ctx_len:  # reject before queueing
            raise ValueError(f"prompt length {len(prompt)} >= ctx_len "
                             f"{self.ctx_len}")
        if self.paged and \
                pages_needed(min(len(prompt), self.C),
                             self.page_size) > self.n_pages:
            raise ValueError(f"prompt needs more pages than the pool has "
                             f"({self.n_pages})")
        rid = self._next_rid
        self._next_rid += 1
        self._t_submit[rid] = self.recorder.clock.perf()
        lane = None if self.async_prefill else next(
            (i for i, s in enumerate(self.slots) if s is None), None)
        if lane is None or self.pending:  # keep FIFO order under overload
            self.pending.append((rid, list(prompt), max_new_tokens))
            self._m_queue.set(len(self.pending))
            self.recorder.emit("serve/queue", rid=rid,
                               depth=len(self.pending))
            return rid
        if not self._try_admit(lane, rid, prompt, max_new_tokens, None):
            self.pending.append((rid, list(prompt), max_new_tokens))
            self._m_queue.set(len(self.pending))
            self.recorder.emit("serve/queue", rid=rid,
                               depth=len(self.pending))
        return rid

    def _alloc_prompt_pages(self, lane: int, rid: int, plen: int):
        """Reserve the lane's prompt pages; None when the pool can't (the
        caller leaves the request queued). Host mirror only — the device
        page-table row binds inside the insert stage."""
        if not self.paged:
            return ()
        need = pages_needed(min(plen, self.C), self.page_size)
        got = self.pool.alloc(rid, need)
        if got is None:
            return None
        row = np.full((self.NP,), -1, np.int32)
        row[:need] = got
        self._pt[lane] = row
        self._page_gauges()
        return row

    def _try_admit(self, lane: int, rid: int, prompt: List[int],
                   max_new_tokens: int, out: Optional[Dict[int, int]]) \
            -> bool:
        """Synchronous admission: prefill (one-shot or chunked), insert,
        first token. False when the page pool can't host the prompt yet."""
        plen = len(prompt)
        page_ids = self._alloc_prompt_pages(lane, rid, plen)
        if page_ids is None:
            if not any(self.slots) and self._inflight is None:
                # nothing will ever free a page (resumed request outgrew
                # the pool): truncate-complete with what it has
                s = self._resume.pop(rid, None)
                if s is not None:
                    now = self.recorder.clock.perf()
                    self._finished[rid] = s.tokens
                    self.recorder.emit("serve/truncate", rid=rid,
                                       lane=lane, generated=len(s.tokens))
                    self._complete(s, now)
                    return True
            return False
        toks = self._ints(prompt)[None]
        cs = min(self.prefill_chunk or self.C, self.C)
        with self.recorder.span("serve/admit", rid=rid, lane=lane,
                                plen=plen):
            if self.arch.xlstm or plen <= cs:
                with self.recorder.span("serve/prefill", rid=rid,
                                        clen=plen):
                    logits, pcache = self._prefill(self.params, toks,
                                                   plen=plen)
                pcache = prefill_to_decode_cache(pcache, self.arch, self.C)
                last = logits[:, -1]
            else:
                pcache, last = self._chunked_prefill(toks, rid)
            first = self._activate(lane, rid, prompt, max_new_tokens,
                                   pcache, last, page_ids)
        if out is not None:
            out[rid] = first
        return True

    def _chunked_prefill(self, toks, rid: int):
        """Stream the prompt through the extension stage in chunks; the
        prefix lives in a B=1 full-capacity slab (ring slots handle
        prompts longer than a sliding-window lane)."""
        plen = toks.shape[1]
        cs = min(self.prefill_chunk or self.C, self.C)
        pf = self._prefix_slab()
        logits = None
        for s0 in range(0, plen, cs):
            chunk = toks[:, s0:s0 + cs]
            pos = torch.arange(s0, s0 + chunk.shape[1], dtype=torch.int32,
                               device=self.device)[None]
            with self.recorder.span("serve/prefill", rid=rid,
                                    chunk=s0 // cs, clen=chunk.shape[1]):
                logits, pf = self._extend(self.params, chunk, pos, pf)
        return pf, logits[:, -1]

    def _activate(self, lane: int, rid: int, prompt: List[int],
                  max_new_tokens: int, pcache, logits_last, page_ids) -> int:
        """Insert the prefix into the lane, draw the first token (keyed by
        (rid, plen) — batch- and resume-independent), and activate the
        request. Shared by sync admission and async prefill completion."""
        plen = len(prompt)
        with self.recorder.span("serve/insert", rid=rid, lane=lane):
            self.cache = insert_prefix(self.cache, pcache, lane,
                                       page_ids if self.paged else None)
            first = int(sample_tokens(logits_last, self._ints([rid]),
                                      self._ints([plen]),
                                      self.sampling)[0])
        now = self.recorder.clock.perf()
        t_sub = self._t_submit.get(rid, now)
        old = self._resume.pop(rid, None)
        self._m_tokens.inc()
        if old is None:
            self._m_admitted.inc()
            self._m_ttft.observe(now - t_sub)
            req = _Req(rid, plen, max_new_tokens - 1, [first],
                       prompt=list(prompt), t_submit=t_sub, t_first=now)
        else:
            # resumed after preemption: keep the original prompt, TTFT and
            # the SAME tokens list object (drain() consumers hold a
            # reference to it); `first` is the recomputed next token
            old.tokens.append(first)
            req = _Req(rid, plen, max_new_tokens - 1, old.tokens,
                       prompt=old.prompt, t_submit=old.t_submit,
                       t_first=old.t_first)
        self.recorder.emit("serve/admit", rid=rid, lane=lane, plen=plen,
                           ttft_s=now - t_sub, queued=len(self.pending),
                           resumed=old is not None)
        if req.remaining <= 0 or (self.eos_id is not None
                                  and first == self.eos_id):
            self._finished[rid] = req.tokens
            self._complete(req, now)
            self._release(lane, rid)
        else:
            self._tok[lane, 0] = first
            self.slots[lane] = req
            self._m_lanes.set(sum(s is not None for s in self.slots))
        return first

    def _complete(self, req: _Req, t_end: float) -> None:
        """Record one request's terminal stats — called exactly once per
        request (at admission for instant completions, else when its lane
        frees); delivery of tokens is a separate concern. request_stats is
        bounded: beyond stats_cap the oldest record is evicted and
        counted in serve_stats_dropped_total."""
        self._m_done.inc()
        dur = t_end - req.t_submit
        n = len(req.tokens)
        stats = {"ttft_s": req.t_first - req.t_submit, "tokens": n,
                 "dur_s": dur, "tok_per_s": (n / dur) if dur > 0 else 0.0}
        self.request_stats[req.rid] = stats
        while len(self.request_stats) > self.stats_cap:
            self.request_stats.pop(next(iter(self.request_stats)))
            self._m_stats_dropped.inc()
        self._t_submit.pop(req.rid, None)
        self.recorder.emit("serve/complete", rid=req.rid, **stats)

    def _drain_pending(self, out: Dict[int, int]):
        """Admit queued requests into free lanes (FIFO); their prefill-
        produced first tokens are reported in `out`. Stops (leaving the
        head queued) when lanes or pages run out."""
        while self.pending:
            lane = next((i for i, s in enumerate(self.slots)
                         if s is None and i != self._reserved), None)
            if lane is None:
                return
            rid, prompt, mnt = self.pending[0]
            if not self._try_admit(lane, rid, prompt, mnt, out):
                return
            self.pending.popleft()
            self._m_queue.set(len(self.pending))

    # -- async chunked prefill --------------------------------------------
    def _advance_prefill(self, out: Dict[int, int]):
        """One unit of prefill work per tick: start the queued head (lane
        + pages reserved), or advance the in-flight prompt by one chunk;
        on the final chunk insert + activate."""
        fl = self._inflight
        if fl is None:
            if not self.pending:
                return
            lane = next((i for i, s in enumerate(self.slots)
                         if s is None), None)
            if lane is None:
                return
            rid, prompt, mnt = self.pending[0]
            page_ids = self._alloc_prompt_pages(lane, rid, len(prompt))
            if page_ids is None:
                return                      # wait for pages to free
            self.pending.popleft()
            self._m_queue.set(len(self.pending))
            cs = min(self.prefill_chunk or self.C, self.C)
            fl = self._inflight = dict(
                rid=rid, lane=lane, prompt=prompt, mnt=mnt, next=0, cs=cs,
                oneshot=self.arch.xlstm or len(prompt) <= cs,
                page_ids=page_ids, pf=None)
            self._reserved = lane
        rid, lane, prompt = fl["rid"], fl["lane"], fl["prompt"]
        plen = len(prompt)
        if fl["oneshot"]:
            toks = self._ints(prompt)[None]
            with self.recorder.span("serve/prefill", rid=rid, clen=plen):
                logits, pcache = self._prefill(self.params, toks, plen=plen)
            pcache = prefill_to_decode_cache(pcache, self.arch, self.C)
            self._finish_prefill(fl, pcache, logits[:, -1], out)
            return
        if fl["pf"] is None:
            fl["pf"] = self._prefix_slab()
        s0 = fl["next"]
        chunk = self._ints(prompt[s0:s0 + fl["cs"]])[None]
        pos = torch.arange(s0, s0 + chunk.shape[1], dtype=torch.int32,
                           device=self.device)[None]
        with self.recorder.span("serve/prefill", rid=rid,
                                chunk=s0 // fl["cs"], clen=chunk.shape[1]):
            logits, fl["pf"] = self._extend(self.params, chunk, pos,
                                            fl["pf"])
        fl["next"] = s0 + chunk.shape[1]
        if fl["next"] >= plen:
            self._finish_prefill(fl, fl["pf"], logits[:, -1], out)

    def _finish_prefill(self, fl: dict, pcache, logits_last,
                        out: Dict[int, int]):
        first = self._activate(fl["lane"], fl["rid"], fl["prompt"],
                               fl["mnt"], pcache, logits_last,
                               fl["page_ids"])
        out[fl["rid"]] = first
        self._inflight = None
        self._reserved = None

    # -- one engine tick ---------------------------------------------------
    def step(self) -> Dict[int, int]:
        """Advance every active lane one token; returns {rid: token}; frees
        finished lanes and admits queued requests into them (a queued
        request's first entry in the dict is its prefill-produced token).
        Requests that completed at admission are delivered here too — their
        single token, exactly once — so polling step() observes every
        request and `_finished` stays bounded. With async_prefill each tick
        also advances the in-flight prompt by one chunk."""
        out: Dict[int, int] = {}
        if self.paged and any(self.slots):
            self._ensure_pages()            # may preempt / truncate lanes
        if any(self.slots):
            n_active = sum(s is not None for s in self.slots)
            with self.recorder.span("serve/step", active=n_active,
                                    lanes=self.max_batch) as sp:
                host = self._lanes_host.numpy()
                host[0] = [s.pos if s else 0 for s in self.slots]
                host[1] = [s.rid if s else -1 for s in self.slots]
                self._lanes.copy_(self._lanes_host, non_blocking=True)
                nxt = self._tick()
                # the next tick's input, before a replay overwrites nxt
                self._tok.copy_(nxt[:, None])
                sp.sync(nxt)
                nxt_host = nxt.tolist()
            now = self.recorder.clock.perf()
            for i, s in enumerate(self.slots):
                if s is None:
                    continue
                t = int(nxt_host[i])
                s.tokens.append(t)
                s.pos += 1
                s.remaining -= 1
                self._m_tokens.inc()
                out[s.rid] = t
                if s.remaining <= 0 or (self.eos_id is not None
                                        and t == self.eos_id):
                    self.slots[i] = None  # lane freed for the next request
                    self._complete(s, now)
                    self._release(i, s.rid)
        if self.async_prefill:
            self._advance_prefill(out)
        else:
            self._drain_pending(out)
        self._m_lanes.set(sum(s is not None for s in self.slots))
        self._m_queue.set(len(self.pending))
        for rid, toks in self._finished.items():
            if toks:
                out.setdefault(rid, toks[-1])
        self._finished.clear()
        return out

    def drain(self) -> Dict[int, List[int]]:
        """Run until all active AND queued requests finish; returns
        {rid: tokens} (including requests that completed at admission)."""
        results: Dict[int, List[int]] = {
            s.rid: s.tokens for s in self.slots if s}
        results.update(self._finished)
        self._finished.clear()
        while any(self.slots) or self.pending or self._inflight is not None:
            out = self.step()
            for s in self.slots:
                if s is not None and s.rid not in results:
                    results[s.rid] = s.tokens
            for rid, t in out.items():  # completed at admission in step()
                results.setdefault(rid, [t])
        return results
