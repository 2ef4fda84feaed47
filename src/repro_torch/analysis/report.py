"""Render the port's run records: a dry run's results into its memory and
roofline tables, numerics-observatory dumps (DESIGN.md §9) into
per-layer fidelity and decision tables, a serving record into its stage
and traffic tables, and a JSONL run-log (`obs.JSONLSink`), followed live
(DESIGN.md §12). A stdlib-only copy of `repro.analysis.report`: the same
text for the same input, but that the memory table asks whether a cell
fits one H100's 80 GiB and the roofline table names Hopper's remedies.

    python -m repro_torch.launch.dryrun --all --mesh both \
        --out results/dryrun.json        # the port's dry run writes it
    python -m repro_torch.analysis.report results/dryrun.json
    python -m repro_torch.analysis.report --numerics results/numerics.json
    python -m repro_torch.analysis.report --serve BENCH_serve.json
    python -m repro_torch.analysis.report --follow results/runlog.jsonl

(with `src/` on PYTHONPATH).

`--follow` renders events as they arrive (progress lines, controller
decisions with their signal, the per-layer table of every numerics
snapshot, checkpoint, autotune and serving events) and exits at the end
of the file; `--watch` keeps polling for new lines (Ctrl-C stops).
"""
import json
import sys

HBM_GIB = 80   # one H100's device memory


def memory_table(results):
    lines = ["| arch | shape | mesh | args GiB | temps GiB | total GiB | "
             f"fits H100 {HBM_GIB}G |", "|---|---|---|---|---|---|---|"]
    for cell, rec in sorted(results.items()):
        if rec.get("status") != "ok" or "memory" not in rec:
            continue
        m = rec["memory"]
        args = m["argument_bytes"] / 2**30
        temp = m["temp_bytes"] / 2**30
        tot = m["per_device_total_gib"]
        fits = "yes" if tot <= HBM_GIB else "**no**"
        lines.append(f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | "
                     f"{args:.2f} | {temp:.2f} | {tot:.2f} | {fits} |")
    return "\n".join(lines)


def roofline_table(results):
    lines = ["| arch | shape | mesh | compute s | memory s | collective s |"
             " bound | model/HLO flops | roofline frac | 1-sentence fix |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    fixes = {
        ("compute", "train"): "more int8 wgmma share / fewer remat GEMMs",
        ("memory", "train"): "fuse quantize into the GEMM (one kernel); "
        "microbatch + SP to shrink residuals",
        ("collective", "train"): "BFP-compress DP grad all-reduce; "
        "reduce-scatter into ZeRO shards over NVLink",
        ("memory", "prefill"): "fused HBFP flash attention keeps scores in "
        "shared memory",
        ("collective", "prefill"): "shard seq (SP) instead of gathering kv",
        ("memory", "decode"): "narrow-BFP (int8) weights + cache halve "
        "reads",
        ("collective", "decode"): "replicate small weights; all-gather "
        "cache shards only",
    }
    for cell, rec in sorted(results.items()):
        if rec.get("status") != "ok" or "roofline" not in rec:
            continue
        r = rec["roofline"]
        kind = ("train" if rec["shape"].startswith("train") else
                "prefill" if rec["shape"].startswith("prefill") else
                "decode")
        fix = fixes.get((r["bottleneck"], kind), "-")
        lines.append(
            f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | "
            f"{r['compute_s']:.3g} | {r['memory_s']:.3g} | "
            f"{r['collective_s']:.3g} | {r['bottleneck']} | "
            f"{r.get('useful_flops_ratio', 0):.2f} | "
            f"{r.get('roofline_fraction', 0):.2%} | {fix} |")
    skipped = [(rec["arch"], rec["shape"]) for rec in results.values()
               if rec.get("status") == "skipped"]
    tail = "\nSkipped cells (assignment rule, DESIGN.md §5): " + \
        ", ".join(f"{a}×{s}" for a, s in sorted(set(skipped)))
    return "\n".join(lines) + tail


def render_dryrun(path):
    """`path`: a dry run's results, {cell: record}."""
    with open(path) as f:
        results = json.load(f)
    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_sk = sum(1 for r in results.values() if r["status"] == "skipped")
    n_er = sum(1 for r in results.values() if r["status"] == "error")
    print(f"cells: {n_ok} ok / {n_sk} skipped / {n_er} error\n")
    print("### Memory (per device)\n")
    print(memory_table(results))
    print("\n### Roofline\n")
    print(roofline_table(results))
    for cell, rec in sorted(results.items()):
        if rec.get("status") == "error":
            print(f"\nERROR {cell}: {rec['error']}")


def numerics_table(snapshot, widths=None):
    """Per-layer fidelity table from one telemetry snapshot (the
    `{source: {layer: stats}}` dict a `RingBuffer` entry holds; see
    `numerics.stats.stats_to_host`). Snapshots recorded by
    `train.make_step` carry per-tap resolved widths ("widths": weight tap
    at the fwd width, grad tap at the wgrad width — DESIGN.md §11), which
    take precedence over the controller-width fallback so per-role
    policies render with both widths visible."""
    tap_widths = snapshot.get("widths", {})
    lines = ["| layer | bits | source | SQNR dB | clip frac | sat tiles | "
             "FTZ frac | exp spread |",
             "|---|---|---|---|---|---|---|---|"]
    for source in ("weights", "grads", "acts"):
        for layer, s in sorted(snapshot.get(source, {}).items()):
            bits = "-" if widths is None else widths.get(layer, widths.get(
                "__base__", "-"))
            bits = tap_widths.get(source, {}).get(layer, bits)
            lines.append(
                f"| {layer} | {bits} | {source} | {s['sqnr_db']:.1f} | "
                f"{s['clip_frac']:.2e} | {s.get('sat_tile_frac', 0.0):.3f} | "
                f"{s['ftz_frac']:.3f} | {s['exp_spread']:.0f} |")
    return "\n".join(lines)


def decision_table(log):
    """Render a controller decision log (`PrecisionController.log` /
    checkpoint meta "numerics_controller"."log")."""
    if not log:
        return "(no decisions)"
    lines = ["| step | layer | action | from | to | reason | SQNR dB | "
             "clip |", "|---|---|---|---|---|---|---|---|"]
    for d in log:
        pfx = "b" if d.get("axis") == "block" else "m"
        lines.append(f"| {d['step']} | {d['layer']} | {d['action']} | "
                     f"{pfx}{d['from']} | {pfx}{d['to']} | {d['reason']} | "
                     f"{d['sqnr_db']:.1f} | {d['clip_frac']:.3f} |")
    return "\n".join(lines)


def render_numerics(path):
    """`path`: JSON with {"snapshot": {...}, "controller": to_meta() dump}
    (what examples/adaptive_precision.py writes)."""
    with open(path) as f:
        dump = json.load(f)
    ctrl = dump.get("controller", {})
    widths = dict(ctrl.get("widths", {}))
    widths["__base__"] = ctrl.get("base_bits", "-")
    step = dump.get("step")
    print(f"### Per-layer numerics{'' if step is None else f' @ step {step}'}"
          "\n")
    print(numerics_table(dump.get("snapshot") or {}, widths))
    print("\n### Controller decision log\n")
    print(decision_table(ctrl.get("log", [])))


def serve_table(record):
    """Render BENCH_serve.json (benchmarks/serve_bench) into the stage
    unit-cost list + per-rate traffic table."""
    s = record.get("stages_us", {})
    lines = [f"paged KV: page_size {record.get('page_size')}, "
             f"{record.get('n_pages')} pages, {record.get('max_batch')} "
             f"lanes x ctx {record.get('ctx_len')} "
             f"({record.get('backend')})", "",
             f"stage unit costs: prefill {s.get('prefill_us', 0):.0f} us "
             f"({s.get('prefill_tokens')} tok) | extend "
             f"{s.get('extend_us', 0):.0f} us ({s.get('extend_chunk')}-tok "
             f"chunk) | insert {s.get('insert_us', 0):.0f} us | generate "
             f"{s.get('generate_us', 0):.0f} us "
             f"({s.get('generate_lanes')} lanes)", "",
             "| rate req/s | reqs | goodput tok/s | ttft p50/p95/p99 ms | "
             "tok/s p50 | queue p95 | lane util p95 | pages p95 | preempt |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in record.get("traffic", []):
        t = r["ttft_s"]
        occ = r.get("page_occupancy")
        pages = "-" if occ is None else f"{occ['p95']:.2f}"
        lines.append(
            f"| {r['rate_req_s']:g} | {r['n_requests']} | "
            f"{r['goodput_tok_s']:g} | {t['p50'] * 1e3:.1f} / "
            f"{t['p95'] * 1e3:.1f} / {t['p99'] * 1e3:.1f} | "
            f"{r['tok_per_s']['p50']:g} | {r['queue_depth']['p95']} | "
            f"{r['lane_util']['p95']:.2f} | {pages} | "
            f"{r.get('preemptions', 0)} |")
    return "\n".join(lines)


def render_serve(path):
    with open(path) as f:
        record = json.load(f)
    print("### Serving traffic benchmark\n")
    print(serve_table(record))


def _follow_lines(path, watch=False, interval=0.5):
    """Yield complete lines from `path`; at EOF either stop (default) or
    poll for appended lines (`watch=True`). A partial trailing line (the
    sink mid-write) is held until its newline arrives."""
    import time as _time
    buf = ""
    with open(path) as f:
        while True:
            chunk = f.readline()
            if chunk:
                buf += chunk
                if buf.endswith("\n"):
                    yield buf
                    buf = ""
                continue
            if not watch:
                if buf:
                    yield buf  # writer is gone; flush what we have
                return
            _time.sleep(interval)


def follow_runlog(path, *, watch=False, interval=0.5, out=print):
    """Tail a JSONL run-log (written by `obs.JSONLSink`) and render events
    live. Unknown kinds and span events are counted but not printed (the
    schema is open — see obs.events.KINDS); returns the per-kind counts."""
    counts = {}
    n_dec = 0
    for line in _follow_lines(path, watch=watch, interval=interval):
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn write / rotation seam
        kind = ev.get("kind")
        data = ev.get("data", {})
        step = ev.get("step")
        counts[kind] = counts.get(kind, 0) + 1
        if kind == "train/progress":
            extras = " ".join(
                f"{k} {v:.4f}" for k, v in data.items()
                if isinstance(v, (int, float)) and k != "elapsed_s")
            out(f"step {step:>6} {extras} ({data.get('elapsed_s', 0.):.1f}s)")
        elif kind == "train/recompile":
            out(f"[recompile] step {step}: m{data.get('mantissa_bits')} "
                f"overrides={data.get('n_overrides', 0)} "
                f"backend={data.get('backend')} "
                f"variants={data.get('n_variants')}")
        elif kind == "numerics/snapshot":
            out(f"\n-- per-layer numerics @ step {step} --")
            out(numerics_table(data))
            out("")
        elif kind == "precision/decision":
            n_dec += 1
            if data.get("axis") == "block":
                # block-axis moves (shrink_block/grow_block, DESIGN.md §13)
                out(f"[BLOCK] step {step} {data.get('layer')}: "
                    f"b{data.get('from')} -> b{data.get('to')} "
                    f"({data.get('action')}: {data.get('reason')}, "
                    f"sqnr {data.get('sqnr_db', 0.):.1f} dB, "
                    f"clip {data.get('clip_frac', 0.):.3f})")
            else:
                out(f"[{str(data.get('action', '?')).upper()}] step {step} "
                    f"{data.get('layer')}: m{data.get('from')} -> "
                    f"m{data.get('to')} ({data.get('reason')}, "
                    f"sqnr {data.get('sqnr_db', 0.):.1f} dB, "
                    f"clip {data.get('clip_frac', 0.):.3f})")
        elif kind == "ckpt/save":
            out(f"[ckpt] saved step {step}: "
                f"{data.get('bytes', 0) / 2**20:.2f} MiB in "
                f"{data.get('dur_s', 0.):.2f}s ({data.get('path')})")
        elif kind == "ckpt/load":
            out(f"[ckpt] restored step {step} "
                f"({data.get('bytes', 0) / 2**20:.2f} MiB)")
        elif kind == "autotune/winner":
            out(f"[autotune] {data.get('key')}: tiles={data.get('tiles')} "
                f"speedup {data.get('speedup')}x")
        elif kind == "serve/complete":
            out(f"[serve] rid {data.get('rid')}: {data.get('tokens')} tok, "
                f"ttft {data.get('ttft_s', 0.) * 1e3:.1f} ms, "
                f"{data.get('tok_per_s', 0.):.1f} tok/s")
    total = sum(counts.values())
    by_kind = " ".join(f"{k}:{counts[k]}" for k in sorted(counts))
    out(f"\n{total} events ({by_kind}); {n_dec} precision decisions")
    return counts


def main():
    args = sys.argv[1:]
    if args[:1] == ["--follow"]:
        paths = [a for a in args[1:] if not a.startswith("--")]
        try:
            follow_runlog(paths[0] if paths else "results/runlog.jsonl",
                          watch="--watch" in args[1:])
        except KeyboardInterrupt:
            pass
        return 0
    if args[:1] == ["--numerics"]:
        render_numerics(args[1] if len(args) > 1
                        else "results/numerics.json")
        return 0
    if args[:1] == ["--serve"]:
        render_serve(args[1] if len(args) > 1 else "BENCH_serve.json")
        return 0
    render_dryrun(args[0] if args else "results/dryrun.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
