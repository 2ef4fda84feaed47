"""The reference's flash gate in the port, on yi-9b smoke under
"8; backend=pallas".

Where the reference's un-jitted `prefill` (and `forward`, the training
path) takes its fused flash kernel `flash_mha` — full-causal pattern, no
softcap, positions absent or a concrete arange, nearest rounding — the
port raises, naming ROADMAP B4, instead of computing mha logits. Explicit
offset positions stay on mha in both packages, and the serving stages,
which stand in for the reference's jitted ones, keep mha.
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


def test_port_raises_where_reference_takes_flash(models, monkeypatch):
    ja, ta, jp, tp, tok = models
    calls = []
    real = jattention.flash_mha
    monkeypatch.setattr(jattention, "flash_mha",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    jctx = JCtx(policy=jparse_policy(SPEC).resolve_segment(0))
    tctx = Ctx(policy=parse_policy(SPEC).resolve_segment(0), device="cpu")
    for batch in _batches(tok):
        calls.clear()
        jtransformer.prefill(jp, jax.tree.map(jnp.asarray, batch), ja, jctx)
        assert calls, "the reference's un-jitted prefill takes flash_mha"
        with pytest.raises(NotImplementedError, match="B4"):
            prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                    ta, tctx)
    # offset positions: mha in both packages, and the same logits
    calls.clear()
    batch = _batches(tok, offset=3)[0]
    jl, _ = jtransformer.prefill(jp, jax.tree.map(jnp.asarray, batch), ja,
                                 jctx)
    assert not calls
    tl, _ = prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                    ta, tctx)
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= 2e-3 * np.abs(jl).max()


def test_training_path_keeps_the_gate(models):
    """yi-9b's training forward takes flash in the reference, so the
    port's loss raises (its training slice comes with B4-B6); gemma2's
    local/global softcapped attention never takes flash."""
    from repro_torch.models import loss_fn
    _, ta, _, tp, tok = models
    tctx = Ctx(policy=parse_policy(SPEC).resolve_segment(0), device="cpu")
    batch = {"tokens": torch.from_numpy(tok),
             "labels": torch.from_numpy(tok)}
    with pytest.raises(NotImplementedError, match="B4"):
        loss_fn(tp, batch, ta, tctx)


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
