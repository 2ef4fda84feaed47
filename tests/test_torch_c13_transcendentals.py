"""ROADMAP C13: the port's f32 transcendentals (`torch.cos`, `sin`, `pow`)
differ from XLA's by a few ulps. These tests pin how far that moves the
LR schedules and the RoPE tables, over whole runs and 4,096 positions,
each within a stated bound. Bit equality is not the aim: it would need
XLA's own cos, sin and pow in the port.

Run on the CPU:
    PYTHONPATH=src python -m pytest tests/test_torch_c13_transcendentals.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.optim.schedule import make_schedule as jax_schedule
from repro_torch.models import layers as tlayers
from repro_torch.optim.schedule import make_schedule as torch_schedule

# cosine and wsd at every step of both runs, the reference evaluated op by
# op (measured worst case: 10 ulps, cosine at base 6e-4; wsd 5) and under
# jit, as its train step sees it (measured: 10, cosine and wsd at 6e-4;
# XLA turns the divisions by constants into products by reciprocals, so
# constant differs there too, by 2)
SCHEDULE_ULPS = 16
# RoPE inverse frequencies (measured: 1 ulp at (96, 1e4) and (128, 1e6),
# equal elsewhere)
INV_FREQ_ULPS = 1
# rotated f32 q/k, absolute (measured: 4.8e-7 where the inverse
# frequencies are equal, 7.2e-7 at (128, 1e6))
ROPE_F32_ABS = 1e-6
# rotated bf16 q/k, in bf16 ulps of the larger magnitude (measured: 1)
ROPE_BF16_ULPS = 1

RUNS = ((3e-4, 10, 1000, 0.1), (6e-4, 100, 5000, 0.05))
ROPE_SHAPES = ((64, 1e4), (96, 1e4), (128, 1e4), (128, 5e5), (128, 1e6))
POSITIONS = 4096


def _ulps(a, b) -> np.ndarray:
    """|a - b| in f32 ulps (a, b of one sign)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("kind", ["cosine", "wsd", "constant"])
@pytest.mark.parametrize("run", RUNS, ids=["3e-4x1000", "6e-4x5000"])
def test_schedule_matches_reference_at_every_step(kind, run, jit):
    base, warmup, total, final = run
    kw = dict(base_lr=base, warmup_steps=warmup, total_steps=total,
              final_frac=final)
    ref = jax_schedule(kind, **kw)
    ref = jax.jit(ref) if jit else ref
    port = torch_schedule(kind, **kw)
    steps = range(total + 1)
    want = np.array([np.float32(ref(jnp.int32(s))) for s in steps])
    got = np.array([np.float32(port(s)) for s in steps])
    assert (want > 0).sum() == total      # one sign: ulps are meaningful
    if kind == "constant" and not jit:
        np.testing.assert_array_equal(got, want)
    else:
        assert _ulps(got, want).max() <= SCHEDULE_ULPS


@pytest.mark.parametrize("hd,theta", ROPE_SHAPES)
def test_rope_matches_reference_over_4096_positions(hd, theta):
    ref_inv = np.asarray(jlayers.rope_freqs(hd, theta))
    inv = tlayers.rope_freqs(hd, theta).numpy()
    assert _ulps(inv, ref_inv).max() <= INV_FREQ_ULPS

    rng = np.random.default_rng(hd + int(np.log10(theta)))
    x = rng.standard_normal((1, 2, POSITIONS, hd)).astype(np.float32)
    pos = np.arange(POSITIONS, dtype=np.int32)[None]
    # an inverse frequency one ulp apart turns the f32 angle at position p
    # by p·Δinv and at most one ulp of the angle more (it rounds to another
    # neighbour); a rotation by δ moves an output pair by at most |pair|·δ
    # (zero where the inverse frequencies are equal)
    dinv = np.abs(inv - ref_inv)
    ang = (pos[0][:, None] * inv).astype(np.float32)
    turn = pos[0][:, None] * dinv + np.spacing(ang) * (dinv > 0)
    pair = np.sqrt(x[..., :hd // 2] ** 2 + x[..., hd // 2:] ** 2)
    drift = np.concatenate([pair * turn] * 2, axis=-1)

    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         theta))
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta).numpy()
    assert (np.abs(got - want) <= ROPE_F32_ABS + drift).all()

    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jlayers.apply_rope(xb, jnp.asarray(pos), theta)
                      .astype(jnp.float32))
    got = tlayers.apply_rope(torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(pos), theta).float().numpy()
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    assert (np.abs(got - want) <= ROPE_BF16_ULPS * ulp + drift).all()
