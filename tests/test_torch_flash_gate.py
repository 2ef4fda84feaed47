"""The reference's flash gate in the port, on yi-9b smoke under
"8; backend=pallas".

Where the reference's un-jitted `prefill` (and `forward`, the training
path) takes its fused flash kernel `flash_mha` — full-causal pattern, no
softcap, positions absent or a concrete arange, nearest rounding — the
port takes its own `flash_mha` (B4 forward, B5/B6 backward) and gives the
same logits, loss and grads within stated tolerances. Explicit offset
positions stay on mha in both packages, and the serving stages, which
stand in for the reference's jitted ones, keep mha.

Tolerances: f32 logits within 2e-3 of their range (ulp-level op
differences and the occasional BFP rounding flip they cause, ROADMAP C6);
the training loss and grads as `tests/test_torch_train.py` states them
for HBFP (loss 2e-3 relative, grads 3e-2 in relative Frobenius norm per
leaf; the worst leaf measured here is 0.4%).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import attention as jattention
from repro.models import init_params as jinit_params
from repro.models import transformer as jtransformer
from repro.models.layers import Ctx as JCtx
from repro.precision import parse_policy as jparse_policy
from repro_torch.configs import get_arch
from repro_torch.models import from_jax_params, prefill
from repro_torch.models.layers import Ctx
from repro_torch.precision import parse_policy
from repro_torch.train import serve_step as tss

SPEC = "8; backend=pallas"


@pytest.fixture(scope="module")
def models():
    ja = dataclasses.replace(jget_arch("yi-9b").smoke(), dtype="float32")
    ta = dataclasses.replace(get_arch("yi-9b").smoke(), dtype="float32")
    jp = jinit_params(jax.random.key(0), ja)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    tok = np.random.default_rng(0).integers(0, ja.vocab_size,
                                            (2, 8)).astype(np.int32)
    return ja, ta, jp, tp, tok


def _batches(tok, offset=None):
    pos = np.broadcast_to(np.arange(tok.shape[1], dtype=np.int32),
                          tok.shape).copy()
    out = [{"tokens": tok}, {"tokens": tok, "positions": pos}]
    if offset is not None:
        out = [{"tokens": tok, "positions": pos + offset}]
    return out


def _counted(monkeypatch, module, calls, key):
    real = module.flash_mha
    monkeypatch.setattr(module, "flash_mha", lambda *a, **k: (
        calls.__setitem__(key, calls[key] + 1), real(*a, **k))[1])


def test_port_raises_where_reference_takes_flash(models, monkeypatch):
    """(Name kept from when the port raised here.) The port's un-jitted
    prefill takes flash_mha exactly where the reference's does, and gives
    the reference's logits."""
    from repro_torch.models import attention as tattention
    ja, ta, jp, tp, tok = models
    calls = {"ref": 0, "port": 0}
    _counted(monkeypatch, jattention, calls, "ref")
    _counted(monkeypatch, tattention, calls, "port")
    jctx = JCtx(policy=jparse_policy(SPEC).resolve_segment(0))
    tctx = Ctx(policy=parse_policy(SPEC).resolve_segment(0), device="cpu")
    for batch in _batches(tok) + _batches(tok, offset=3):
        flash = "positions" not in batch or not batch["positions"][0, 0]
        calls.update(ref=0, port=0)
        jl, _ = jtransformer.prefill(jp, jax.tree.map(jnp.asarray, batch),
                                     ja, jctx)
        tl, _ = prefill(tp, {k: torch.from_numpy(v)
                             for k, v in batch.items()}, ta, tctx)
        # the reference traces its layer scan's body once; the port's
        # Python loop calls flash_mha once per layer
        assert (calls["ref"] > 0) == flash, (batch.keys(), calls)
        assert calls["port"] == (ja.n_layers if flash else 0), calls
        jl = np.asarray(jl)
        assert np.abs(tl.numpy() - jl).max() <= 2e-3 * np.abs(jl).max()


def test_training_path_keeps_the_gate(models):
    """(Name kept from when the port raised here.) yi-9b's training loss
    takes flash in both packages: the port's loss_fn and its grads (B4 in
    the forward and the per-layer recompute, B5/B6 in the backward) match
    the reference's loss_fn through its flash custom VJP (Pallas in
    interpret mode), from the reference's weights."""
    from repro_torch.kernels import hbfp_flash_attn as fa
    from repro_torch.models import loss_fn
    ja, ta, jp, tp, tok = models
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    jctx = JCtx(policy=jparse_policy(SPEC).resolve_segment(0))
    (jl, _), jg = jax.value_and_grad(
        lambda p: jtransformer.loss_fn(p, jax.tree.map(jnp.asarray, batch),
                                       ja, jctx), has_aux=True)(jp)
    tctx = Ctx(policy=parse_policy(SPEC).resolve_segment(0), device="cpu")
    leaves = _leaves(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    fa.reset_counts()
    tl, _ = loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                    ta, tctx)
    tl.backward()
    L = ta.n_layers
    assert (fa.hbfp_flash_fwd.plain_calls, fa.hbfp_flash_dq.plain_calls,
            fa.hbfp_flash_dkv.plain_calls) == (2 * L, L, L)
    assert abs(float(tl.detach()) - float(jl)) <= 2e-3 * abs(float(jl))
    jleaves = _leaves(jax.tree.map(np.asarray, jg))
    for name, t in leaves.items():
        a, b = jleaves[name], t.grad.numpy()
        err = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)
        assert err <= 3e-2, (name, err)
        t.requires_grad_(False)
        t.grad = None


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_leaves(v, name))
        else:
            out[name] = v
    return out


def test_serving_stages_stay_on_mha(models):
    """The stages pass std_pos=False: an arange-positioned prefill through
    make_prefill_fn runs mha, bit-identical to prefill(std_pos=False)."""
    _, ta, _, tp, tok = models
    pol = parse_policy(SPEC)
    params = tss.narrow_serving_params(tp, ta, pol)
    batch = {k: torch.from_numpy(v) for k, v in _batches(tok)[1].items()}
    stage = tss.make_prefill_fn(ta, pol, device="cpu")
    a, _ = stage(params, batch)
    ctx = Ctx(policy=dataclasses.replace(
        pol.resolve_segment(0),
        global_cfg=pol.resolve_segment(0).global_cfg.with_(
            requantize_weights=False)), device="cpu")
    b, _ = prefill(params, batch, ta, ctx, std_pos=False)
    assert torch.equal(a, b)
