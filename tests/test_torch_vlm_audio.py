"""qwen2-vl-72b (M-RoPE, embeddings input) and musicgen-large (embeddings
input, four codebook heads) in the port against the JAX package, at
smoke size (2 layers, d 128, hd 32) on the reference's weights and
batches, handed over as numpy.

* `apply_mrope`: bf16 bit-equal to the reference at (hd 32, θ 1e6), with
  text positions (where it equals `apply_rope`) and an image grid (t
  fixed over the image, h and w its rows and columns); f32 and (hd 128,
  θ 1e6) within ROADMAP C13's RoPE bounds (XLA's and torch's f32 sin and
  cos differ in the last ulps, and at (128, 1e6) one inverse frequency
  differs by an ulp).
* Both smoke models' logits, loss and grads under "fp32" and "8;
  backend=pallas" (flash B4-B6 and B1-B3 through their plain versions,
  the reference's Pallas kernels in interpret mode), with
  `test_torch_train.py`'s tolerances (TOL below); qwen2-vl also under
  "8" with an image-grid span, which takes the sim-path attention in
  both; musicgen also with its CE in two chunks. Launch counts with K
  heads: B1 2·7L + K, B2 and B3 7L + K in one CE chunk; B1 2·(7L + K·C),
  B2 and B3 7L + K·C in C chunks.
* Two `make_step` steps (qwen2-vl in fp32; musicgen under "8", its heads
  on the sim path: losses, moments and updates); decode
  over embeddings frame by frame reproducing the forward's last logits;
  the port's prefill and decode stages against the reference's compiled
  ones (SERVE_TOL, as `test_torch_families.py`).
* Compiling the reference takes most of this file's time, so the cases
  are the fewest that reach each new path once.
* The codebook-token input's embedding sum bit-equal in bf16; the four
  head sites folding one key, as the reference's (its `key_for` reads
  the site name's first four bytes); the [K, D, V] head narrowed per
  [D, V] slice bit-equal to the reference, its weight and grad stats
  equal to the reference's; checkpoints across both ways; `ServeEngine`
  refusing embeddings input.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_arch as jget_arch
from repro.core.opt_shell import narrow_params as jnarrow
from repro.data.pipeline import batch_for_arch as jbatch
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models.layers import Ctx as JCtx
from repro.models.transformer import _embed_in as jembed_in
from repro.models.transformer import forward as jforward
from repro.models.transformer import loss_fn as jloss_fn
from repro.numerics import stats_to_host as jhost
from repro.numerics.collect import grad_stats as jgrad_stats
from repro.numerics.collect import weight_stats as jweight_stats
from repro.optim import make_schedule as jmake_schedule
from repro.precision import parse_policy as jparse_policy
from repro.precision.policy import ResolvedPolicy as JResolvedPolicy
from repro.train import init_train_state as jinit_train_state
from repro.train import make_step as jmake_step
from repro.train import serve_step as jss
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.core.opt_shell import narrow_params
from repro_torch.data import batch_for_arch
from repro_torch.kernels import hbfp_flash_attn as fa
from repro_torch.kernels import hbfp_matmul as hm
from repro_torch.models import (Ctx, decode_step, forward, from_jax_params,
                                init_params, make_cache)
from repro_torch.models import layers as tlayers
from repro_torch.models.transformer import _embed_in
from repro_torch.numerics import TapConfig, stats_to_host
from repro_torch.optim import make_schedule
from repro_torch.precision import parse_policy
from repro_torch.serve import ServeEngine
from repro_torch.train import TrainState, from_jax_train_state, make_step
from repro_torch.train import serve_step as tss

FAMILIES = ("qwen2-vl-72b", "musicgen-large")
LR = 1e-3
TOL = {  # loss (rel), grads, moments, updates (rel Frobenius per leaf)
    "hbfp": dict(loss=2e-3, grads=3e-2, moments=1e-1, updates=0.25),
    "fp32": dict(loss=1e-5, grads=1e-3, moments=1e-3, updates=1e-3),
}
SERVE_SPEC = "8; backend=pallas"
SERVE_TOL = {"float32": 2e-3, "bfloat16": 2e-2}
# C13's RoPE bounds (tests/test_torch_c13_transcendentals.py): rotated
# f32 q/k absolute, and the inverse frequencies in f32 ulps
ROPE_F32_ABS = 1e-6
INV_FREQ_ULPS = 1
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one intra-op thread avoids oversubscribing
    the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _archs(name, **kw):
    ja = dataclasses.replace(jget_arch(name).smoke(), **kw)
    ta = dataclasses.replace(get_arch(name).smoke(), **kw)
    assert dataclasses.asdict(ja) == dataclasses.asdict(ta)
    return ja, ta


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, _f32(tree)


def _compare(what, ref, got, tol, base=None):
    """Relative Frobenius error per leaf <= tol; returns the bit-equal
    share over all elements."""
    base = dict(_flat(base)) if base is not None else {}
    same = total = 0
    for (n, a), (n2, b) in zip(_flat(ref), _flat(got)):
        assert n == n2 and a.shape == b.shape, (what, n, n2)
        if n in base:
            a, b = a - base[n], b - base[n]
        err = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)
        assert err <= tol, (what, n, err)
        same += int((a == b).sum())
        total += a.size
    return same / total


def _close(ref, got, tol, what):
    ref, got = _f32(ref), _f32(got)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    err = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                               1e-30)
    assert err <= tol, (what, err)
    return err


def _compile(fn, *args):
    """The reference's jitted stage without XLA's excess precision (C1)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _grid_positions(b, s):
    """[3, b, s] M-RoPE positions of text, a 2 x 4 image and text again:
    text tokens have t = h = w; the image's patches share t and take h, w
    from their row and column; text after it resumes at the largest
    position + 1 (Qwen2-VL §2.1). s >= 16."""
    p = np.zeros((3, s), np.int32)
    p[:, :4] = np.arange(4)
    r, c = np.divmod(np.arange(8), 4)
    p[0, 4:12], p[1, 4:12], p[2, 4:12] = 4, 4 + r, 4 + c
    p[:, 12:] = np.arange(8, 8 + s - 12)
    return np.broadcast_to(p[:, None], (3, b, s)).copy()


def _text_positions(arch, b, s):
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    return np.broadcast_to(pos, (3, b, s)).copy() if arch.mrope \
        else pos.copy()


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


# ----------------------------------------------------------------------------
# M-RoPE
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["text", "grid"])
@pytest.mark.parametrize("hd", [32, 128])
def test_mrope_matches_reference(hd, layout):
    theta = 1e6
    inv, ref_inv = (tlayers.rope_freqs(hd, theta).numpy(),
                    np.asarray(jlayers.rope_freqs(hd, theta)))
    assert _ulps(inv, ref_inv).max() <= (0 if hd == 32 else INV_FREQ_ULPS)
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((B, 4, S, hd)).astype(np.float32)
    pos = _grid_positions(B, S) if layout == "grid" else \
        np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    # an inverse frequency one ulp apart turns the angle at position p by
    # p·Δinv and one ulp of the angle more; a pair of |r| moves by r·turn
    # (C13's bound, per section's own position component)
    half = hd // 2
    s0, s1 = int(half * 0.25), int(half * 0.375)
    comp = np.repeat([0, 1, 2], [s0, s1, half - s0 - s1])
    p = pos[comp].transpose(1, 2, 0)[:, None]                # [B,1,S,half]
    dinv = np.abs(inv - ref_inv)
    turn = p * dinv + np.spacing((p * inv).astype(np.float32)) * (dinv > 0)
    pair = np.sqrt(x[..., :half] ** 2 + x[..., half:] ** 2)
    drift = np.concatenate([pair * turn] * 2, axis=-1)
    tx, tp = torch.from_numpy(x), torch.from_numpy(pos)
    want = np.asarray(jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                          theta))
    got = tlayers.apply_mrope(tx, tp, theta).numpy()
    assert (np.abs(got - want) <= ROPE_F32_ABS + drift).all()
    want = np.asarray(jlayers.apply_mrope(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos), theta)
        .astype(jnp.float32))
    got = tlayers.apply_mrope(tx.bfloat16(), tp, theta).float().numpy()
    if hd == 32:
        np.testing.assert_array_equal(got, want)
    else:
        big = np.maximum(np.abs(got), np.abs(want))
        ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp + drift).all()
    if layout == "text":
        # t = h = w reduces M-RoPE to RoPE, bit for bit
        assert torch.equal(tlayers.apply_mrope(tx, tp, theta),
                           tlayers.apply_rope(tx, tp[0], theta))


# ----------------------------------------------------------------------------
# training
# ----------------------------------------------------------------------------

def _reference_grads(ja, spec, state, batch):
    """The reference's narrow -> value_and_grad of one train step, as its
    make_train_step composes them for a uniform policy, and its logits on
    the same compute copy."""
    seg = jparse_policy(spec).resolve_segment(0)
    act = pcfg = None
    if seg.global_cfg is not None:
        act = seg.global_cfg.with_(
            requantize_weights=seg.backend == "pallas")
        pcfg = seg.global_cfg.with_(requantize_weights=False)
    ctx = JCtx(policy=JResolvedPolicy(global_cfg=act, backend=seg.backend))
    narrow = jnarrow(state.params, pcfg)

    def loss_and_logits(n, b):
        return jloss_fn(n, b, ja, ctx)[0], jforward(n, b, ja, ctx)[0]

    # one compile for both: the logits ride along as the aux output
    grad = jax.jit(jax.value_and_grad(loss_and_logits, has_aux=True))
    (loss, logits), g = grad(narrow, batch)
    return float(loss), _np(g), logits, _np(narrow)


@pytest.fixture(scope="module", params=FAMILIES)
def train_setup(request):
    ja, ta = _archs(request.param, dtype="float32", loss_chunk=32)
    s0 = jinit_train_state(jax.random.key(0), ja, jinit_params)
    batches = [_np(jbatch(ja, B, S, step=i)) for i in range(2)]
    return ja, ta, s0, batches


def _check_loss_and_grads(ja, ta, s0, batch, spec, grid=False):
    loss, grads, jlogits, narrow = _reference_grads(ja, spec, s0, batch)
    sched = make_schedule("constant", base_lr=LR, warmup_steps=0,
                          total_steps=10)
    step = make_step(ta, spec, sched, device="cpu")
    state = from_jax_train_state(_np(s0), device="cpu")
    hm.reset_counts()
    fa.reset_counts()
    tloss, _, tgrads = step.grads(state, _torch_batch(batch))
    tol = TOL["fp32" if spec == "fp32" else "hbfp"]
    # 7 projections a layer (recomputed under remat) and K heads once a
    # CE chunk, recomputed in the backward when there are C > 1 chunks;
    # flash with the synthesized positions only
    L, K, lc = ta.n_layers, ta.n_codebooks, ta.loss_chunk
    C = B * S // lc if B * S > lc else 1
    per = 7 * L + K * C
    calls = (hm.hbfp_matmul_fwd.plain_calls, hm.hbfp_dgrad.plain_calls,
             hm.hbfp_wgrad.plain_calls, fa.hbfp_flash_fwd.plain_calls,
             fa.hbfp_flash_dq.plain_calls, fa.hbfp_flash_dkv.plain_calls)
    flash = (0, 0, 0) if grid else (2 * L, L, L)
    b1 = 2 * per if C > 1 else 2 * per - K
    assert calls == (((b1, per, per) + flash)
                     if spec.endswith("pallas") else (0,) * 6), calls
    assert abs(float(tloss) - loss) <= tol["loss"] * loss
    assert "embed_table" not in tgrads
    share = _compare("grads", grads, tgrads, tol["grads"])
    seg = parse_policy(spec).resolve_segment(0)
    ctx = Ctx(cfg=None if seg.global_cfg is None else
              seg.global_cfg.with_(requantize_weights=seg.backend == "pallas"),
              backend=seg.backend, device="cpu")
    with torch.no_grad():
        tlogits, _ = forward(from_jax_params(narrow, device="cpu"),
                             _torch_batch(batch), ta, ctx)
    want = (B, S, K, ta.vocab_size) if K > 1 else (B, S, ta.vocab_size)
    assert tuple(tlogits.shape) == want
    _close(jlogits, tlogits, 2e-3 if spec != "fp32" else 1e-5, "logits")
    print(f"{ta.name} {spec!r} grid={grid}: loss ref {loss:.6f} port "
          f"{float(tloss):.6f}; bit-equal grads {share:.3f}")


# "8" (the sim path): qwen2-vl's in the image-grid case below,
# musicgen's in its two steps
@pytest.mark.parametrize("train_setup,spec", [
    ("qwen2-vl-72b", "fp32"), ("qwen2-vl-72b", "8; backend=pallas"),
    ("musicgen-large", "fp32"), ("musicgen-large", "8; backend=pallas")],
    indirect=["train_setup"])
def test_forward_loss_and_grads_match_reference(spec, train_setup):
    ja, ta, s0, batches = train_setup
    _check_loss_and_grads(ja, ta, s0, batches[0], spec)


@pytest.mark.parametrize("train_setup", ["musicgen-large"], indirect=True)
def test_chunked_codebook_loss_and_grads_match_reference(train_setup):
    """musicgen's CE over two chunks of 16 tokens: [16, K] labels a chunk,
    the K heads recomputed in the backward under remat (B1 2·(7L + 2K),
    B2 and B3 7L + 2K), against the reference's chunk scan."""
    ja, ta, s0, batches = train_setup
    ja, ta = (dataclasses.replace(a, loss_chunk=16) for a in (ja, ta))
    _check_loss_and_grads(ja, ta, s0, batches[0], "8; backend=pallas")


def test_image_grid_loss_and_grads_match_reference():
    """qwen2-vl with an image-grid span (t fixed, h and w a 2 x 4 grid):
    explicit positions take the sim-path attention in both packages (under
    "8": the kernel backend's GEMMs are the case above)."""
    ja, ta = _archs(FAMILIES[0], dtype="float32", loss_chunk=32)
    s0 = jinit_train_state(jax.random.key(0), ja, jinit_params)
    batch = dict(_np(jbatch(ja, B, S)), positions=_grid_positions(B, S))
    _check_loss_and_grads(ja, ta, s0, batch, "8", grid=True)


# the reference's step compiles in seconds under these specs (its Pallas
# interpret path takes several times longer); musicgen's narrows the
# [K, D, V] head at 8 bits
@pytest.mark.parametrize("train_setup,spec", [
    ("qwen2-vl-72b", "fp32"), ("musicgen-large", "8")],
    indirect=["train_setup"])
def test_two_steps_match_reference(spec, train_setup):
    ja, ta, s0, batches = train_setup
    kw = dict(base_lr=LR, warmup_steps=0, total_steps=10)
    jstep = jmake_step(ja, spec, jmake_schedule("constant", **kw))
    s1, m1 = jstep(s0, batches[0], jax.random.key(1))
    s2, m2 = jstep(s1, batches[1], jax.random.key(2))
    ref = _np(s2)
    step = make_step(ta, spec, make_schedule("constant", **kw), device="cpu")
    state = from_jax_train_state(_np(s0), device="cpu")
    tb = [_torch_batch(b) for b in batches]
    state, tm1 = step(state, tb[0])
    state, tm2 = step(state, tb[1])
    tol = TOL["fp32" if spec == "fp32" else "hbfp"]
    for a, b in ((m1, tm1), (m2, tm2)):
        assert abs(float(a["loss"]) - float(b["loss"])) <= \
            tol["loss"] * abs(float(a["loss"]))
    _compare("mu", ref.opt.mu, state.opt.mu, tol["moments"])
    _compare("nu", ref.opt.nu, state.opt.nu, tol["moments"])
    _compare("updates", ref.params, state.params, tol["updates"],
             base=_np(s0).params)
    worst = max(float(np.abs(a - b).max()) for (_, a), (_, b) in zip(
        _flat(ref.params), _flat(state.params)))
    assert worst <= 8 * LR, worst
    assert state.step == 2 and state.opt.step == 2


def test_batch_for_arch_shapes():
    """Embeddings [B,S,D] f32 and [B,S,K] codebook labels, as the
    reference's `batch_for_arch` lays them out."""
    for name in FAMILIES:
        ja, ta = _archs(name)
        want = {k: (v.shape, np.dtype(v.dtype).kind)
                for k, v in _np(jbatch(ja, B, S)).items()}
        got = {k: (tuple(v.shape), np.dtype(str(v.dtype).replace(
            "torch.", "")).kind) for k, v in batch_for_arch(
                ta, B, S, device="cpu").items()}
        assert got == want
        assert got["embeds"] == ((B, S, ta.d_model), "f")


# ----------------------------------------------------------------------------
# the codebook inputs and heads
# ----------------------------------------------------------------------------

def test_codebook_token_input_sums_bit_equal_bf16():
    """A token-input arch with K codebooks embeds [B,S,K] tokens as the sum
    of their K embeddings, bit-equal to the reference's in bf16 (no
    shipped config takes this input: musicgen's frontend hands over the
    summed embeddings)."""
    ja, ta = _archs("musicgen-large", input_kind="tokens")
    rng = np.random.default_rng(5)
    table = rng.standard_normal((ja.vocab_size, ja.d_model)) * 0.02
    jp = {"embed_table": jnp.asarray(table, jnp.bfloat16)}
    tp = from_jax_params(_np(jp), device="cpu")
    assert tp["embed_table"].dtype == torch.bfloat16
    assert tuple(init_params(0, ta, device="cpu")["embed_table"].shape) == \
        table.shape
    tok = rng.integers(0, ja.vocab_size,
                       (B, S, ja.n_codebooks)).astype(np.int32)
    want, wpos = jax.jit(lambda p, b: jembed_in(p, b, ja, None))(
        jp, {"tokens": tok})
    got, pos = _embed_in(tp, {"tokens": torch.from_numpy(tok)}, ta, "cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(wpos))


def test_head_sites_fold_the_references_key():
    """`key_for` folds the site name's first four bytes, so "head0" ..
    "head3" share one stochastic key in both packages (the reference's
    rule, kept; "head" folds the same)."""
    spec = "8~stochastic"
    jctx = JCtx(policy=jparse_policy(spec).resolve_segment(0),
                key=jax.random.key(7))
    tctx = Ctx(policy=parse_policy(spec).resolve_segment(0), key=7,
               device="cpu")
    jkeys = [np.asarray(jax.random.key_data(jctx.key_for(f"head{k}")))
             for k in range(4)]
    tkeys = [tctx.key_for(f"head{k}") for k in range(4)]
    assert all(np.array_equal(k, jkeys[0]) for k in jkeys)
    assert np.array_equal(np.asarray(jax.random.key_data(
        jctx.key_for("head"))), jkeys[0])
    assert len(set(tkeys)) == 1 and tkeys[0] == tctx.key_for("head")
    assert tctx.key_for("wq") != tkeys[0]


def test_codebook_head_narrowing_and_stats_match_reference():
    """musicgen smoke's [K, D, V] head: narrowed per [D, V] slice bit-equal
    to the reference's (1, tile, tile) tiles; a telemetry step's weight
    stats of it equal the reference's `weight_stats` on the same master,
    and its grad stats the reference's `grad_stats` on the same
    gradient."""
    ja, ta = _archs("musicgen-large", dtype="float32", loss_chunk=32)
    s0 = jinit_train_state(jax.random.key(0), ja, jinit_params)
    cfg = jparse_policy("8").resolve_segment(0)
    want = np.asarray(jnarrow(s0.params, cfg.global_cfg)["head_w"])
    master = from_jax_train_state(_np(s0), device="cpu")
    got = narrow_params(master.params, parse_policy("8").resolve_segment(0))
    np.testing.assert_array_equal(_f32(got["head_w"]), want)
    batch = _torch_batch(_np(jbatch(ja, B, S)))
    sched = make_schedule("constant", base_lr=LR, warmup_steps=0,
                          total_steps=10)
    step = make_step(ta, "8; backend=pallas", sched,
                     tap=TapConfig(cadence=1), device="cpu")
    _, mt = step(from_jax_train_state(_np(s0), device="cpu"), batch)
    _, _, grads = step.grads(from_jax_train_state(_np(s0), device="cpu"),
                             batch)
    pairs = (
        (stats_to_host(mt["numerics"]["weights"])["head_w"],
         jhost(jweight_stats({"head_w": s0.params["head_w"]}, cfg))
         ["head_w"]),
        (stats_to_host(mt["numerics"]["grads"])["head_w"],
         jhost(jgrad_stats({"head_w": jnp.asarray(_f32(grads["head_w"]))},
                           cfg))["head_w"]))
    for got, want in pairs:
        assert got["exp_hist"] == want["exp_hist"]
        assert abs(got["sqnr_db"] - want["sqnr_db"]) <= 1e-3
        for k in ("clip_frac", "sat_tile_frac", "ftz_frac", "exp_spread",
                  "n"):
            assert abs(got[k] - want[k]) <= 1e-6 * max(1.0, abs(want[k])), k


@pytest.fixture(scope="module")
def musicgen_state():
    ja, _ = _archs("musicgen-large")
    return jinit_train_state(jax.random.key(0), ja, jinit_params)


@pytest.mark.parametrize("packed", [False, True])
def test_checkpoints_cross_load_with_codebook_head(tmp_path, packed,
                                                    musicgen_state):
    """musicgen smoke's train state (no embedding table, the [K, D, V]
    head) written by either package loads in the other, plain and packed
    at 8 bits."""
    js = musicgen_state
    like = from_jax_train_state(_np(js), device="cpu")
    assert like.params["head_w"].ndim == 3
    assert "embed_table" not in like.params
    jsave(str(tmp_path / "ref"), 3, js, hbfp=jparse_policy("8"),
          packed=packed)
    restored, _ = load_checkpoint(str(tmp_path / "ref"), like)
    jback, _ = jload(str(tmp_path / "ref"), js)
    want = from_jax_train_state(_np(jback), device="cpu")
    for (n, a), (_, b) in zip(_flat(want.params), _flat(restored.params)):
        assert np.array_equal(a, b), n
    save_checkpoint(str(tmp_path / "port"), 3,
                    TrainState(like.params, like.opt, 0),
                    hbfp=parse_policy("8"), packed=packed)
    jgot, _ = jload(str(tmp_path / "port"), js)
    for (n, a), (_, b) in zip(_flat(_np(jback.params)),
                              _flat(_np(jgot.params))):
        assert np.array_equal(a, b), n


# ----------------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_decode_over_embeds_matches_forward(family):
    """Frame-by-frame decode over embeddings (the caller supplies each
    frame's; nothing is fed back) reproduces the forward's last logits
    in f32 (the reference's `test_decode_matches_forward`)."""
    _, ta = _archs(family, dtype="float32")
    params = init_params(0, ta, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, 13, ta.d_model)).astype(np.float32))
    pos = torch.from_numpy(_text_positions(ta, B, 13))
    ctx = Ctx(device="cpu")
    with torch.no_grad():
        full, _ = forward(params, {"embeds": x, "positions": pos}, ta, ctx)
        cache = make_cache(params, ta, B, 13)
        for t in range(13):
            lg, cache = decode_step(params, {"embeds": x[:, t:t + 1],
                                             "positions": pos[..., t:t + 1]},
                                    cache, ta, ctx)
    err = float((lg[:, 0] - full[:, -1]).abs().max())
    assert err <= 1e-4 * max(float(full[:, -1].abs().max()), 1.0), err


def _serve_params(ja, ta, dtype):
    jp = jinit_params(jax.random.key(0), dataclasses.replace(
        ja, dtype="float32"))
    jpol, tpol = jparse_policy(SERVE_SPEC), parse_policy(SERVE_SPEC)
    # both sides cast the f32 weights to the compute dtype first, then
    # narrow (round-to-nearest-even casts agree bit for bit)
    jparams = jss.narrow_serving_params(
        jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)) if a.ndim >= 2
                     else a, jp), ja, jpol)
    tparams = tss.narrow_serving_params(
        from_jax_params(_np(jp), device="cpu", dtype=getattr(torch, dtype)),
        ta, tpol)
    return jparams, tparams, jpol, tpol


@pytest.mark.parametrize("family,dtype", [
    ("qwen2-vl-72b", "bfloat16"), ("musicgen-large", "float32")])
def test_prefill_then_decode_matches_reference(family, dtype):
    """The serve-step stages over embeddings: a 12-frame prefill (qwen2-vl
    with an image-grid span in it) and 3 decode steps on next-frame
    embeddings, against the reference's compiled stages."""
    ja, ta = _archs(family, dtype=dtype)
    jparams, tparams, jpol, tpol = _serve_params(ja, ta, dtype)
    P, C = 12, 32
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((B, P + 3, ja.d_model)).astype(np.float32)
    pos = _grid_positions(B, P + 3) if ja.mrope else \
        _text_positions(ja, B, P + 3)
    pre = {"embeds": emb[:, :P], "positions": pos[..., :P]}
    jl, jc = _compile(jss.make_prefill_fn(ja, jpol), jparams, pre)(
        jparams, pre)
    jc = jss.prefill_to_decode_cache(jc, ja, C)
    tl, tc = tss.make_prefill_fn(ta, tpol, device="cpu")(
        tparams, _torch_batch(pre))
    tc = tss.prefill_to_decode_cache(tc, ta, C)
    tdec = tss.make_decode_fn(ta, tpol, device="cpu")
    errs = [_close(jl, tl, SERVE_TOL[dtype], "prefill")]
    jdec = None
    for t in range(P, P + 3):
        dec = {"embeds": emb[:, t:t + 1], "positions": pos[..., t:t + 1]}
        if jdec is None:
            jdec = _compile(jss.make_decode_fn(ja, jpol), jparams, dec, jc)
        jd, jc = jdec(jparams, dec, jc)
        td, tc = tdec(tparams, _torch_batch(dec), tc)
        errs.append(_close(jd, td, SERVE_TOL[dtype], f"decode {t}"))
    K = ta.n_codebooks
    assert tuple(td.shape) == ((B, 1, K, ta.vocab_size) if K > 1
                               else (B, 1, ta.vocab_size))
    print(f"{family} {dtype}: prefill, decode max|d|/max|ref| {errs}")


@pytest.mark.parametrize("family", FAMILIES)
def test_engine_refuses_embeddings_input(family):
    """The engine serves token input only, as the reference's; these
    archs serve through the serve-step stages."""
    _, ta = _archs(family)
    params = init_params(0, ta, device="cpu")
    with pytest.raises(NotImplementedError, match="serve-step stages"):
        ServeEngine(ta, params, parse_policy(SERVE_SPEC), device="cpu")
