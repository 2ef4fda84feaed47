"""The port's run-log renderers (`repro_torch.analysis.report`) print the
reference's text (`repro.analysis.report`) for the same input: the
per-layer numerics table (with and without per-tap widths) and the
controller's decision log (mantissa and block axes), the numerics dump,
the serving record, and a JSONL run-log that the port's `JSONLSink` wrote
while `autotune_op` tuned a GEMM and a smoke model trained two steps,
`autotune/winner` included. The inputs are synthetic dicts, no file from
the repo's BENCH_* records.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.analysis import report as jrep
from repro_torch.analysis import report as trep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SNAPSHOT = {
    "weights": {"layers.0.wq": dict(sqnr_db=31.25, clip_frac=1.5e-4,
                                    sat_tile_frac=0.0625, ftz_frac=0.002,
                                    exp_spread=7.0),
                "head_w": dict(sqnr_db=29.5, clip_frac=0.0, ftz_frac=0.0,
                               exp_spread=3.0)},
    "grads": {"layers.0.wq": dict(sqnr_db=12.75, clip_frac=3e-3,
                                  sat_tile_frac=0.5, ftz_frac=0.125,
                                  exp_spread=19.0)},
    "acts": {"layer0": dict(sqnr_db=40.0, clip_frac=0.0, ftz_frac=0.0,
                            exp_spread=2.0)},
}
WIDTHS = {"weights": {"layers.0.wq": 8}, "grads": {"layers.0.wq": 12}}
LOG = [dict(step=4, layer="layers.0.wq", action="widen", **{"from": 4},
            to=8, reason="sqnr_floor", sqnr_db=11.04, clip_frac=0.0123),
       dict(step=9, layer="head_w", action="shrink_block", axis="block",
            **{"from": 64}, to=16, reason="sat_tiles", sqnr_db=20.0,
            clip_frac=0.5)]
SERVE = {"page_size": 16, "n_pages": 256, "max_batch": 8, "ctx_len": 1024,
         "backend": "pallas",
         "stages_us": {"prefill_us": 1234.5, "prefill_tokens": 128,
                       "extend_us": 321.0, "extend_chunk": 64,
                       "insert_us": 12.0, "generate_us": 15820.25,
                       "generate_lanes": 8},
         "traffic": [
             {"rate_req_s": 2.0, "n_requests": 12, "goodput_tok_s": 275.6,
              "ttft_s": {"p50": 0.0759, "p95": 1.1705, "p99": 2.7392},
              "tok_per_s": {"p50": 31.5}, "queue_depth": {"p95": 3},
              "lane_util": {"p95": 0.875},
              "page_occupancy": {"p95": 0.5}, "preemptions": 1},
             {"rate_req_s": 0.5, "n_requests": 4, "goodput_tok_s": 80.25,
              "ttft_s": {"p50": 0.05, "p95": 0.06, "p99": 0.07},
              "tok_per_s": {"p50": 40.0}, "queue_depth": {"p95": 0},
              "lane_util": {"p95": 0.5}}]}


@pytest.mark.parametrize("widths", [None, {"__base__": 4,
                                           "layers.0.wq": 8}])
@pytest.mark.parametrize("tap_widths", [False, True])
def test_numerics_table_matches_reference(widths, tap_widths):
    snap = dict(SNAPSHOT, widths=WIDTHS) if tap_widths else SNAPSHOT
    assert trep.numerics_table(snap, widths) == \
        jrep.numerics_table(snap, widths)


@pytest.mark.parametrize("log", [[], LOG], ids=["empty", "two"])
def test_decision_table_matches_reference(log):
    assert trep.decision_table(log) == jrep.decision_table(log)


def test_serve_table_matches_reference():
    assert trep.serve_table(SERVE) == jrep.serve_table(SERVE)
    assert trep.serve_table({}) == jrep.serve_table({})


def test_render_numerics_and_serve_match_reference(tmp_path, capsys):
    dump = tmp_path / "numerics.json"
    dump.write_text(json.dumps({
        "step": 12, "snapshot": SNAPSHOT,
        "controller": {"widths": {"layers.0.wq": 8}, "base_bits": 4,
                       "log": LOG}}))
    rec = tmp_path / "serve.json"
    rec.write_text(json.dumps(SERVE))
    texts = []
    for mod in (trep, jrep):
        mod.render_numerics(str(dump))
        mod.render_serve(str(rec))
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1]
    assert "### Per-layer numerics @ step 12" in texts[0]


@pytest.fixture(scope="module")
def runlog(tmp_path_factory):
    """A JSONL run-log written by the port's JSONLSink: a tile search on
    the CPU (menu (32, 64), one timing each) and two smoke training steps
    (HBFP8 on the sim path), plus the events the trainer does not emit
    here."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import autotune, ops
    from repro_torch.obs import JSONLSink, Recorder
    from repro_torch.optim import make_schedule
    from repro_torch.train import Trainer, init_train_state, make_step
    d = tmp_path_factory.mktemp("runlog")
    path = str(d / "run.jsonl")
    sink = JSONLSink(path, mode="w")
    rec = Recorder([sink], run_id="t")
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    w = torch.randn(64, 64, generator=torch.Generator().manual_seed(1))
    autotune.autotune_op(
        "matmul_fwd", lambda t: ops.hbfp_matmul(x, w, bm=t[0], bk=t[1],
                                                bn=t[2]),
        64, 64, 64, table=autotune.TuningTable(path=str(d / "t.json")),
        menu=(32, 64), n=1, save=False, recorder=rec)
    arch = get_arch("gemma2-2b").smoke()
    pipe = SyntheticLM(arch.vocab_size, 17, 4, seed=7, device="cpu")
    sched = make_schedule("constant", base_lr=1e-3, warmup_steps=0,
                          total_steps=10)
    step = make_step(arch, "8", sched, device="cpu", recorder=rec)
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # small eager ops beside other workers
    try:
        Trainer(train_step=step,
                init_state=init_train_state(0, arch, device="cpu"),
                data_fn=pipe.batch, recorder=rec, device="cpu").run(
            2, log_every=1, log_fn=lambda s: None)
    finally:
        torch.set_num_threads(n)
    rec.emit("precision/decision", step=2,
             **{k: v for k, v in LOG[0].items() if k != "step"})
    rec.emit("ckpt/save", step=2, bytes=3 * 2 ** 20, dur_s=0.25, path="x")
    rec.emit("serve/complete", rid=3, tokens=32, ttft_s=0.0759,
             tok_per_s=275.6)
    sink.close()
    return path


def test_follow_runlog_matches_reference(runlog):
    outs = []
    for mod in (trep, jrep):
        lines = []
        counts = mod.follow_runlog(runlog, out=lines.append)
        outs.append((counts, lines))
    assert outs[0] == outs[1]
    counts, lines = outs[0]
    text = "\n".join(lines)
    assert counts["autotune/winner"] == 1 and counts["train/progress"] == 2
    assert "[autotune] matmul_fwd/64x64x64/float32/m8/b0: tiles=" in text
    assert "[WIDEN] step 2 layers.0.wq: m4 -> m8" in text
    assert text.count("step      ") >= 2


def test_follow_torn_last_line_and_cli(runlog, tmp_path):
    """A trailing line without its newline (the sink mid-write) is
    flushed at the end of the file alike; `python -m
    repro_torch.analysis.report --follow` prints the rendered log, and
    with a results file and no flag it prints the dry run's tables."""
    torn = tmp_path / "torn.jsonl"
    with open(runlog) as f:
        body = f.read()
    torn.write_text(body + '{"kind": "train/prog')
    outs = [[], []]
    for mod, out in zip((trep, jrep), outs):
        mod.follow_runlog(str(torn), out=out.append)
    assert outs[0] == outs[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis.report",
                        "--follow", runlog], capture_output=True, text=True,
                       env=env, timeout=120)
    assert r.returncode == 0 and "[autotune]" in r.stdout
    dry = tmp_path / "dryrun.json"
    dry.write_text(json.dumps({"yi-9b|train_4k|single": {
        "arch": "yi-9b", "shape": "train_4k", "mesh": "single",
        "status": "ok", "memory": {"argument_bytes": 2**31,
                                   "temp_bytes": 2**30,
                                   "per_device_total_gib": 3.5}}}))
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis.report",
                        str(dry)], capture_output=True, text=True, env=env,
                       timeout=120)
    assert r.returncode == 0 and "fits H100 80G" in r.stdout
    assert "| yi-9b | train_4k | single | 2.00 | 1.00 | 3.50 | yes |" \
        in r.stdout
