#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py            # one CUDA device; builds the kernels

Phases (any failure exits non-zero before the result line):
  1. device   — require CUDA, print the card and its power limit, turn
                TF32 off for matmuls and convolutions;
  2. build    — compile every kernel source with nvcc (one process per
                source, started together) and print registers/spills;
  3. kernels  — each kernel against its plain PyTorch version on the card
                at the yi-9b serving shapes, timed with CUDA events;
  4. model    — the yi-9b smoke model served on the card (kernel path)
                agrees with the same model on the CPU (plain path);
  5. serve    — yi-9b at full width (random seeded bf16 weights) served by
                the port's ServeEngine: 12 overloading requests, paged and
                slab, plus one async chunked-prefill request; every
                projection must have gone through the kernels;
  6. report   — the `kernels` JSON line, the card line, and the last line
                {"ok": true, "device": {...}}.

Per-case kernel numbers also go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and ops/s by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}

SERVE_SHAPES = {            # weight: (K, N) at yi-9b full width
    "wq": (4096, 4096), "wk": (4096, 512), "wv": (4096, 512),
    "wo": (4096, 4096), "ffn_wg": (4096, 11008), "ffn_wi": (4096, 11008),
    "ffn_wo": (11008, 4096), "head": (4096, 64000),
}
KERNEL_MS = (1, 8, 256)
# (name, quantize_w, mantissa_bits, block, stochastic)
CONFIGS = (("served", False, 8, 0, False),
           ("qw_m8", True, 8, 0, False),
           ("qw_m12", True, 12, 0, False),
           ("qw_m8_b32", True, 8, 32, False),
           ("qw_m8_stoch", True, 8, 0, True))
# block > 0 sums dequantized operands whose exponents vary inside a
# K-block, in another order than the plain version: hold them to this
# fraction of the output's largest magnitude
BLOCK_TOL = 1e-5


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"{name}, power limit not read"
    log(f"[device] {name} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | count {torch.cuda.device_count()}")
    log(f"[device] nvidia-smi: {card}")
    return name, card


def phase_build():
    from repro_torch.kernels import hbfp_matmul as hm
    builds = {"hbfp_matmul_fwd": (hm.build, hm.load)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as ex:
        futs = {k: ex.submit(b) for k, (b, _) in builds.items()}
        infos = {k: f.result() for k, f in futs.items()}
    for k, (_, load) in builds.items():
        info = infos[k]
        load(info["path"])
        regs = re.findall(r"Function properties for (\S+)[\s\S]*?"
                          r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", info["log"])
        used = re.findall(r"Used (\d+) registers", info["log"])
        spills = sum(int(s) + int(l) for _, s, l in regs)
        log(f"[build] {k}: {info['seconds']:.1f} s, "
            f"{len(used)} kernels, registers {min(map(int, used))}-"
            f"{max(map(int, used))}, spill bytes {spills}")
    log(f"[build] all kernels in {time.perf_counter() - t0:.1f} s")


def _time_ms(fn, n: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _reps(fn) -> int:
    """Launch count for ~40 ms of timing, from one timed call."""
    est = _time_ms(fn, 1)
    return max(3, min(200, int(40.0 / max(est, 1e-3))))


def _bound_ms(M, K, N, x_bytes, w_bytes, kind) -> tuple:
    ops_ms = 2.0 * M * K * N / PEAK_OPS_S[kind] * 1e3
    bytes_ms = (x_bytes * M * K + w_bytes * K * N + 4 * M * N) \
        / HBM_BYTES_S * 1e3
    return (max(ops_ms, bytes_ms), "operations" if ops_ms > bytes_ms
            else "bytes")


def phase_kernels():
    import torch
    from repro_torch.core import HBFP8_16, bfp
    from repro_torch.kernels import hbfp_matmul as hm
    from repro_torch.kernels import autotune
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    cases = []
    for wname, (K, N) in SERVE_SHAPES.items():
        w_raw = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
        w_narrow = bfp.quantize_weight(w_raw, HBFP8_16)
        for M in KERNEL_MS:
            x32 = torch.randn((M, K), generator=gen, device=dev)
            for xdt in (torch.bfloat16, torch.float32):
                x = x32.to(xdt).contiguous()
                for cname, qw, m, block, st in CONFIGS:
                    w = (w_raw if qw else w_narrow).to(xdt).contiguous()
                    bm, bk, bn = autotune.align_tiles(
                        autotune.clip_tiles(autotune.DEFAULT_TILES, M, K, N),
                        block)
                    kw = dict(mantissa_bits=m, stochastic=st, quantize_w=qw,
                              block=block, bm=bm, bk=bk, bn=bn)
                    seed = 0x5EED if st else 0
                    run = lambda: hm.hbfp_matmul_fwd(x, w, seed, **kw)
                    plain = lambda: hm.hbfp_matmul_plain(x, w, seed, **kw)
                    yk = run()
                    yp = plain()
                    torch.cuda.synchronize()
                    err = float((yk - yp).abs().max())
                    scale = float(yp.abs().max())
                    if not torch.isfinite(yk).all():
                        fail(f"non-finite kernel output {wname} M={M} {cname}")
                    if block == 0:
                        ok = torch.equal(yk, yp)
                    else:
                        ok = err <= BLOCK_TOL * scale
                    xb, wb = x.element_size(), w.element_size()
                    ab = x.to(torch.bfloat16)
                    wbf = w.to(torch.bfloat16)
                    mm = lambda: torch.matmul(ab, wbf)
                    kind = ("int8" if qw and m <= 8 and block == 0 else
                            "bf16" if m <= 8 else "f32")
                    bound, by = _bound_ms(M, K, N, xb, wb, kind)
                    n = _reps(run)
                    kms = _time_ms(run, n)
                    pms = _time_ms(plain, 2)
                    mms = _time_ms(mm, n)
                    row = dict(weight=wname, M=M, K=K, N=N,
                               x_dtype=str(xdt).replace("torch.", ""),
                               config=cname, exact_required=block == 0,
                               ok=bool(ok), max_abs_err=err,
                               max_abs_ref=scale, kernel_ms=kms,
                               bound_ms=bound, bound_by=by, plain_ms=pms,
                               matmul_bf16_ms=mms, reps=n)
                    cases.append(row)
                    log(f"[kernel] {wname} M={M} {row['x_dtype'][:4]} "
                        f"{cname} {'EQ' if block == 0 else 'TOL'} "
                        f"err={err:.2g} kernel_ms={kms:.4f} "
                        f"bound_ms={bound:.4f}({by[0]}) plain_ms={pms:.3f} "
                        f"matmul_bf16_ms={mms:.4f}")
                    if not ok:
                        fail(f"kernel != plain: {row}")
        del w_raw, w_narrow
        torch.cuda.empty_cache()
    for cname, *_ in CONFIGS:
        rows = [c for c in cases if c["config"] == cname]
        log(f"[kernel] {cname:11s}: {len(rows)} cases all ok, max_abs_err="
            f"{max(r['max_abs_err'] for r in rows):.3g}, "
            f"kernel_ms total={sum(r['kernel_ms'] for r in rows):.3f}, "
            f"bound_ms total={sum(r['bound_ms'] for r in rows):.3f}")
    return cases


def phase_model():
    """yi-9b smoke in f32: card (kernel) vs CPU (plain) prefill logits and
    greedy decode tokens."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.precision import parse_policy
    from repro_torch.serve import ServeEngine
    arch = dataclasses.replace(get_arch("yi-9b").smoke(), dtype="float32")
    pol = parse_policy("8; backend=pallas")
    p_cpu = init_params(7, arch, device="cpu")
    p_gpu = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                 if isinstance(v, dict) else v.cuda())
             for k, v in p_cpu.items()}
    prompts = [[int(t) for t in torch.randint(
        0, arch.vocab_size, (n,), generator=torch.Generator().manual_seed(n))]
        for n in (5, 9, 17)]
    outs, firsts = {}, {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        eng = ServeEngine(arch, params, pol, max_batch=2, ctx_len=64,
                          device=dev)
        toks = eng._ints(prompts[2])[None]
        logits, _ = eng._prefill(eng.params, toks, plen=len(prompts[2]))
        firsts[dev] = logits.float().cpu()
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        outs[dev] = eng.drain()
    a, b = firsts["cpu"], firsts["cuda"]
    if tuple(b.shape) != (1, 1, arch.vocab_size) or not torch.isfinite(b).all():
        fail(f"bad card logits {tuple(b.shape)}")
    diff = float((a - b).abs().max())
    tol = 2e-3 * float(a.abs().max())
    log(f"[model] yi-9b smoke f32 prefill logits card vs cpu: max|d|="
        f"{diff:.3g} (tol {tol:.3g}); tokens equal: "
        f"{outs['cpu'] == outs['cuda']}")
    if diff > tol:
        fail("card logits disagree with the CPU path")
    if outs["cpu"] != outs["cuda"]:
        fail(f"greedy tokens differ: {outs}")


def _serve_trace(engine_kw, arch, params, pol, prompts, n_new):
    """Drive one engine over the trace; returns (tokens, stats, launches,
    stage calls, generate seconds, plain calls)."""
    import torch
    from repro_torch.kernels import hbfp_matmul as hm
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(arch, params, pol, **engine_kw)
    calls = {"prefill": 0, "extend": 0, "generate": 0}
    gen_s = [0.0]

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            if name != "generate":
                return fn(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            gen_s[0] += time.perf_counter() - t0
            return out
        return run

    eng._prefill = counted("prefill", eng._prefill)
    eng._extend = counted("extend", eng._extend)
    eng._generate = counted("generate", eng._generate)
    torch.cuda.synchronize()
    hm.reset_counts()                      # counts cover the main path only
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p, max_new_tokens=n_new)
    res = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hm.hbfp_matmul_fwd.launches
    plain = hm.hbfp_matmul_fwd.plain_calls
    stats = dict(eng.request_stats)
    del eng
    torch.cuda.empty_cache()
    return res, stats, launches, calls, gen_s[0], plain, wall


def phase_serve(card: str):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.precision import parse_policy
    arch = get_arch("yi-9b")
    pol = parse_policy("8; backend=pallas")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(0, arch)
    torch.cuda.synchronize()
    log(f"[serve] yi-9b full width, {arch.n_layers} layers (no depth cut), "
        f"params {sum(t.numel() for t in _leaves(params)) / 1e9:.2f} B, "
        f"init {time.perf_counter() - t0:.1f} s")
    g = torch.Generator().manual_seed(42)
    lens = [32 + (512 - 32) * i // 11 for i in range(12)]
    prompts = [torch.randint(0, arch.vocab_size, (n,), generator=g).tolist()
               for n in lens]
    per_call = 7 * arch.n_layers + 1
    n_new = 32
    results = {}
    for mode, kw in (("paged", dict(paged=True)), ("slab", dict(paged=False))):
        res, stats, launches, calls, gen_s, plain, wall = _serve_trace(
            dict(max_batch=8, ctx_len=1024, **kw), arch, params, pol,
            prompts, n_new)
        results[mode] = res
        n_calls = sum(calls.values())
        want = per_call * n_calls
        ttft = sorted(s["ttft_s"] for s in stats.values())
        dec_tokens = sum(len(t) - 1 for t in res.values())
        log(f"[serve] {mode}: {len(res)} requests, stage calls {calls}, "
            f"kernel launches {launches} (expected {want}), plain calls "
            f"{plain}, TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms, decode "
            f"{dec_tokens / gen_s:.1f} tok/s over {calls['generate']} "
            f"generate ticks ({gen_s:.2f} s), wall {wall:.2f} s | {card}")
        if len(res) != len(prompts) or any(len(t) != n_new
                                            for t in res.values()):
            fail(f"{mode}: not every request completed: "
                 f"{ {r: len(t) for r, t in res.items()} }")
        if any(not 0 <= t < arch.vocab_size for ts in res.values()
               for t in ts):
            fail(f"{mode}: token out of range")
        if launches != want or plain != 0 or launches == 0:
            fail(f"{mode}: launches {launches} != {want} or plain {plain}")
        if mode == "paged":
            kernel_launches = launches
    if results["paged"] != results["slab"]:
        fail("paged greedy tokens differ from the slab engine's")
    log("[serve] paged == slab greedy tokens on the same trace")
    res, stats, launches, calls, gen_s, plain, wall = _serve_trace(
        dict(max_batch=8, ctx_len=1024, prefill_chunk=128,
             async_prefill=True), arch, params, pol, [prompts[7]], n_new)
    want = per_call * sum(calls.values())
    log(f"[serve] async chunked prefill (chunk 128, prompt {lens[7]}): "
        f"stage calls {calls}, launches {launches} (expected {want}), "
        f"tokens {len(res[0])}")
    if len(res[0]) != n_new or launches != want or plain != 0 \
            or calls["extend"] == 0:
        fail("async chunked prefill run")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[serve] peak device memory {peak:.2f} GiB | {card}")
    return kernel_launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    t0 = time.perf_counter()
    name, card = phase_device()
    phase_build()
    cases = phase_kernels()
    log(f"[time] kernels done at {time.perf_counter() - t0:.1f} s")
    phase_model()
    launches = phase_serve(card)
    log(f"[time] serve done at {time.perf_counter() - t0:.1f} s")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": name, "card": card, "cases": cases}, f,
                  indent=1)
    tick = [c for c in cases if c["config"] == "served" and c["M"] == 8
            and c["x_dtype"] == "bfloat16"]
    entry = {
        "name": "hbfp_matmul_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hbfp_matmul_fwd.cu",
        "replaces": "src/repro/kernels/hbfp_matmul.py:140",
        "held_against": "hbfp_matmul_plain",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        # one generate tick's eight served shapes (seven projections of a
        # layer + head) at M = 8, bf16 activations
        "ms": sum(c["kernel_ms"] for c in tick),
        "plain_ms": sum(c["plain_ms"] for c in tick),
        "bound_ms": sum(c["bound_ms"] for c in tick),
        "bound_by": "bytes" if all(c["bound_by"] == "bytes" for c in tick)
        else "operations",
        "library_ms": None,
        "matmul_bf16_ms": sum(c["matmul_bf16_ms"] for c in tick),
    }
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
