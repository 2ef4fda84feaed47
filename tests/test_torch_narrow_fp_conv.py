"""The narrow-FP and conv ops of the port against the JAX package: the
ops the paper's Table 1 and Table 2 proxies train with
(`benchmarks/table1_narrow_fp.py`, `benchmarks/table2_image_cls.py`).

* `bfp.simulate_narrow_fp` bit-equal to the reference for m in
  {2, 4, 8, 24} x e in {2, 6, 8}, f32 and bf16, on inputs with zeros,
  values below the format's smallest normal and above its largest value;
  `bfp.ste`'s gradient is the identity.
* `hbfp_linear` with and without bias, and `hbfp_conv2d` (1x1, 2x2, 3x3
  and 5x5 kernels, stride 1 and 2, SAME and VALID, nearest rounding),
  forward and grads against `jax.vjp`: the quantized operands are equal
  bit for bit (im2col copies values), so the outputs differ only in the
  order of their f32 sums: max|d| <= 1e-5 * max|ref|.
* The Table 2 proxy conv net, 5 SGD steps in both packages from one numpy
  init and one set of numpy images, under fp32 and hbfp8_16 at tile 24,
  through `narrow_params` / `hbfp_apply_updates` (the 4-D
  `*_kernel_w` leaves stay FP there, as `conv` names an FP parameter):
  loss within 1e-5 relative a step in fp32, 2e-3 under HBFP, where an ulp
  now and then crosses a BFP rounding boundary (ROADMAP C6); params
  within 1e-5 and 1e-3 relative Frobenius norm.
* The Table 1 proxy MLP, 5 STE steps under every format of the paper's
  table, with the same bounds as the conv net's HBFP run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import HBFPConfig as JHBFPConfig
from repro.core import bfp as jbfp
from repro.core import hbfp_ops as jops
from repro.core.opt_shell import hbfp_apply_updates as japply
from repro.core.opt_shell import narrow_params as jnarrow
from repro_torch.core import HBFPConfig, bfp, hbfp_conv2d, hbfp_linear
from repro_torch.core.opt_shell import hbfp_apply_updates, narrow_params

CFG = (HBFPConfig(8, 16, tile=24), JHBFPConfig(8, 16, tile=24))
OP_TOL = 1e-5
TRAIN_TOL = {"fp32": dict(loss=1e-5, params=1e-5),
             "hbfp": dict(loss=2e-3, params=1e-3)}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16 if a.itemsize == 2 else np.uint32)


def _narrow_fp_input(dtype: str) -> np.ndarray:
    """Normals over the whole f32 range, zeros, signed values near 1, and
    f32 subnormals (flushed by every format)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(4096) * np.exp2(rng.integers(-40, 41, 4096))
    x[:64] = 0.0
    x[64:128] = rng.standard_normal(64)
    x[128:160] = rng.standard_normal(32) * 1e-39
    x[160:192] = rng.choice([-1.0, 1.0], 32) * rng.uniform(1, 3.3, 32) * 1e38
    x = x.astype(np.float32)
    return x if dtype == "float32" else \
        np.asarray(jnp.asarray(x, jnp.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e", [2, 6, 8])
@pytest.mark.parametrize("m", [2, 4, 8, 24])
def test_simulate_narrow_fp_bit_equal(m, e, dtype):
    x = _narrow_fp_input(dtype)
    ref = np.asarray(jbfp.simulate_narrow_fp(jnp.asarray(x), m, e))
    tx = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    got = bfp.simulate_narrow_fp(tx, m, e)
    assert got.dtype == tx.dtype
    got = got.float().numpy() if dtype == "bfloat16" else got.numpy()
    ref32 = np.asarray(ref, np.float32)
    assert (_bits(got.astype(np.float32)) == _bits(ref32)).all()
    emax = 2 ** (e - 1) - 1
    # the largest value, as the result's dtype holds it
    maxv = float(torch.tensor((2.0 - 2.0 ** (1 - m)) * 2.0 ** emax,
                              dtype=tx.dtype))
    x32 = np.asarray(x, np.float64)
    # the edges are there: flushed, saturated and exact zeros
    assert (got[np.abs(x32) < 2.0 ** (1 - emax)] == 0).all()
    assert (np.abs(got) <= maxv).all()
    assert (np.abs(got[np.abs(x32) > 2 * maxv]) == maxv).all()
    assert (got[x32 == 0] == 0).all()


def test_ste_gradient_is_identity():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    q = bfp.ste(lambda t: bfp.simulate_narrow_fp(t, 2, 3))
    y = q(x)
    assert (y.detach() == bfp.simulate_narrow_fp(x.detach(), 2, 3)).all()
    w = torch.randn(101, generator=torch.Generator().manual_seed(0))
    (g,) = torch.autograd.grad((y * w).sum(), x)
    assert torch.equal(g, w)


def _close(ref, got, what):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    err = float(np.abs(ref - got).max())
    assert err <= OP_TOL * float(np.abs(ref).max()), (what, err)
    return err


@pytest.mark.parametrize("bias", [False, True])
def test_hbfp_linear_matches_reference(bias):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 10, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 40)) * 0.2).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32) if bias else None
    g = rng.standard_normal((3, 10, 40)).astype(np.float32)
    jargs = (jnp.asarray(x), jnp.asarray(w)) + \
        ((jnp.asarray(b),) if bias else ())
    jy, vjp = jax.vjp(lambda *a: jops.hbfp_linear(
        a[0], a[1], a[2] if bias else None, CFG[1]), *jargs)
    jgrads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).requires_grad_() for a in
             (x, w) + ((b,) if bias else ())]
    ty = hbfp_linear(targs[0], targs[1], targs[2] if bias else None, CFG[0])
    tgrads = torch.autograd.grad(ty, targs, torch.from_numpy(g))
    _close(jy, ty.detach(), "y")
    for i, (jg, tg) in enumerate(zip(jgrads, tgrads)):
        _close(jg, tg, f"grad {i}")


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_hbfp_conv2d_matches_reference(k, stride, padding):
    rng = np.random.default_rng(100 * k + 10 * stride + len(padding))
    x = rng.standard_normal((2, 9, 10, 5)).astype(np.float32)
    w = (rng.standard_normal((k, k, 5, 7)) * 0.3).astype(np.float32)
    jy, vjp = jax.vjp(lambda a, b: jops.hbfp_conv2d(
        a, b, CFG[1], stride=stride, padding=padding),
        jnp.asarray(x), jnp.asarray(w))
    g = rng.standard_normal(jy.shape).astype(np.float32)
    jdx, jdw = vjp(jnp.asarray(g))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    ty = hbfp_conv2d(tx, tw, CFG[0], stride=stride, padding=padding)
    tdx, tdw = torch.autograd.grad(ty, (tx, tw), torch.from_numpy(g))
    errs = [_close(jy, ty.detach(), "y"), _close(jdx, tdx, "dx"),
            _close(jdw, tdw, "dw")]
    # fp32 (cfg None) is the plain convolution in both
    jf = jops.hbfp_conv2d(jnp.asarray(x), jnp.asarray(w), None,
                          stride=stride, padding=padding)
    _close(jf, hbfp_conv2d(torch.from_numpy(x), torch.from_numpy(w), None,
                           stride=stride, padding=padding), "fp32 y")
    print(f"k {k} stride {stride} {padding}: out {tuple(ty.shape)}, "
          f"max|d| y/dx/dw {errs}")


# ---------------------------------------------------------------------------
# Table 2 proxy: the conv net of benchmarks/table2_image_cls.py
# ---------------------------------------------------------------------------

def _images(n=64, hw=8, c=3, classes=10, seed=3):
    rng = np.random.default_rng(seed)
    templates = rng.standard_normal((classes, hw, hw, c))
    y = rng.integers(0, classes, n)
    x = templates[y] + 0.7 * rng.standard_normal((n, hw, hw, c))
    return x.astype(np.float32), y.astype(np.int32)


def _conv_init(seed=42):
    rng = np.random.default_rng(seed)
    return {
        "conv1_kernel_w": (rng.standard_normal((3, 3, 3, 16)) * 0.2),
        "conv2_kernel_w": (rng.standard_normal((3, 3, 16, 32)) * 0.1),
        "fc_w": rng.standard_normal((32, 10)) * 32 ** -0.5,
    }


def _jce(logits, labels):
    lse = jax.nn.logsumexp(logits, axis=-1)
    ll = jnp.take_along_axis(logits, labels[:, None], 1).squeeze(-1)
    return (lse - ll).mean()


def _jnet(p, x, cfg):
    h = jax.nn.relu(jops.hbfp_conv2d(x, p["conv1_kernel_w"], cfg))
    h = jax.lax.reduce_window(h, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                              (1, 2, 2, 1), "VALID")
    h = jax.nn.relu(jops.hbfp_conv2d(h, p["conv2_kernel_w"], cfg))
    h = h.mean(axis=(1, 2))
    return jops.hbfp_matmul(h, p["fc_w"], cfg)


def _tnet(p, x, cfg):
    h = F.relu(hbfp_conv2d(x, p["conv1_kernel_w"], cfg))
    n, hh, ww, c = h.shape
    h = h.reshape(n, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))
    h = F.relu(hbfp_conv2d(h, p["conv2_kernel_w"], cfg))
    h = h.mean(dim=(1, 2))
    return hbfp_linear(h, p["fc_w"], None, cfg)


def _compare_params(jp, tp, tol, what):
    errs = {}
    for k in jp:
        a, b = np.asarray(jp[k]), tp[k].detach().numpy()
        errs[k] = float(np.linalg.norm(a - b)
                        / max(np.linalg.norm(a), 1e-30))
        assert errs[k] <= tol, (what, k, errs[k])
    return errs


@pytest.mark.parametrize("fmt", ["fp32", "hbfp8_16"])
def test_table2_conv_net_matches_reference(fmt):
    tcfg, jcfg = (None, None) if fmt == "fp32" else CFG
    tol = TRAIN_TOL["fp32" if fmt == "fp32" else "hbfp"]
    lr = 0.03
    x, y = _images()
    init = {k: v.astype(np.float32) for k, v in _conv_init().items()}
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    if jcfg is not None:
        # the shell leaves the 4-D conv kernels FP and narrows fc_w
        jn, tn = jnarrow(jp, jcfg), narrow_params(tp, tcfg)
        for k in init:
            same = (np.asarray(jn[k]) == tn[k].numpy()).all()
            assert same and ((np.asarray(jn[k]) == init[k]).all()
                             == k.endswith("kernel_w")), k

    @jax.jit
    def jstep(params, xb, yb):
        narrow = jnarrow(params, jcfg)
        loss, g = jax.value_and_grad(
            lambda p: _jce(_jnet(p, xb, jcfg), yb))(narrow)
        upd = jax.tree.map(lambda g: -lr * g, g)
        return japply(params, upd, jcfg), loss

    jl, tl = [], []
    for i in range(5):
        xb, yb = x[i * 12:(i + 1) * 12], y[i * 12:(i + 1) * 12]
        jp, loss = jstep(jp, jnp.asarray(xb), jnp.asarray(yb))
        jl.append(float(loss))
        narrow = {k: v.detach().requires_grad_()
                  for k, v in narrow_params(tp, tcfg).items()}
        tloss = F.cross_entropy(_tnet(narrow, torch.from_numpy(xb), tcfg),
                                torch.from_numpy(yb).long())
        g = torch.autograd.grad(tloss, list(narrow.values()))
        upd = {k: -lr * gi for k, gi in zip(narrow, g)}
        tp = hbfp_apply_updates(tp, upd, tcfg)
        tl.append(tloss.item())
    for a, b in zip(jl, tl):
        assert abs(a - b) <= tol["loss"] * abs(a), (jl, tl)
    errs = _compare_params(jp, tp, tol["params"], fmt)
    print(f"table 2 proxy {fmt}: losses ref {jl} port {tl}; params "
          f"rel-fro {errs}")


# ---------------------------------------------------------------------------
# Table 1 proxy: the narrow-FP MLP of benchmarks/table1_narrow_fp.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,e", [(2, 8), (4, 8), (8, 8), (24, 8), (24, 6),
                                 (24, 2)])
def test_table1_mlp_matches_reference(m, e):
    lr = 0.05
    x, y = _images(n=80, seed=4)
    x = x.reshape(80, -1)
    d = x.shape[1]
    rng = np.random.default_rng(9)
    w1 = (rng.standard_normal((d, 64)) * d ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((64, 10)) * 64 ** -0.5).astype(np.float32)
    jq = jbfp.ste(lambda t: jbfp.simulate_narrow_fp(t, m, e))
    tq = bfp.ste(lambda t: bfp.simulate_narrow_fp(t, m, e))

    def jloss(a, b, xb, yb):
        h = jax.nn.relu(jq(xb) @ jq(a))
        return _jce(jq(h) @ jq(b), yb)

    @jax.jit
    def jstep(a, b, xb, yb):
        loss, (g1, g2) = jax.value_and_grad(jloss, argnums=(0, 1))(
            a, b, xb, yb)
        return jq(a - lr * jq(g1)), jq(b - lr * jq(g2)), loss

    ja, jb = jnp.asarray(w1), jnp.asarray(w2)
    ta, tb = torch.from_numpy(w1), torch.from_numpy(w2)
    jl, tl = [], []
    for i in range(5):
        xb, yb = x[i * 16:(i + 1) * 16], y[i * 16:(i + 1) * 16]
        ja, jb, loss = jstep(ja, jb, jnp.asarray(xb), jnp.asarray(yb))
        jl.append(float(loss))
        a, b = ta.requires_grad_(), tb.requires_grad_()
        h = F.relu(tq(torch.from_numpy(xb)) @ tq(a))
        loss = F.cross_entropy(tq(h) @ tq(b), torch.from_numpy(yb).long())
        g1, g2 = torch.autograd.grad(loss, (a, b))
        with torch.no_grad():
            ta, tb = tq(a - lr * tq(g1)), tq(b - lr * tq(g2))
        tl.append(loss.item())
    tol = TRAIN_TOL["hbfp"]
    finite = np.isfinite(jl).all()
    assert finite == np.isfinite(tl).all(), (jl, tl)
    if finite:
        for a, b in zip(jl, tl):
            assert abs(a - b) <= tol["loss"] * abs(a), (jl, tl)
        errs = _compare_params({"w1": ja, "w2": jb}, {"w1": ta, "w2": tb},
                               tol["params"], f"m{m} e{e}")
    else:
        errs = None
    print(f"table 1 proxy m {m} e {e}: losses ref {jl} port {tl}; params "
          f"rel-fro {errs}")
