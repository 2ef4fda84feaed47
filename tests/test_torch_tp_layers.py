"""The pieces of tensor parallelism in one process
(`sharding/tensor_parallel.py`, the row-amax input of B1–B3 and of the
sim path):

  * the row-amax quantizer: the parts of a row quantized on the global
    row max are bit-equal to the whole row's Q_row, with `act_block` None
    (one exponent per row: the parts need the reduce) and set (whole
    blocks a part: they need nothing);
  * B1–B3's plain versions with the row-amax input against sliced
    one-process products, at 2 and 4 shards: B3's dequantized operands
    and products bit-equal to the one-process slices, B1's and B2's
    partial sums adding up to the one-process product within the f32
    bound of their order; a row amax equal to the group's own max gives
    the same bits as none;
  * the tile-aligned layout of every architecture at model 2, 4 and 16
    (tile 128): every sharded dim a whole number of tiles and one of
    `fwd_param_specs`' dims, each group sharded whole or replicated whole,
    the replicated leaves listed with their reason (yi-9b's FFN at model
    4 among them: 11,008 / 4 = 2,752 cuts a tile);
  * the vocab-parallel CE and embedding on simulated shards (ranks as
    threads of this process on an in-memory transport), against
    `loss_fn`'s logsumexp and the whole table; the first-step loss of the
    reference's weights on two simulated ranks, with sequence parallelism
    off and on, bit-equal to the port's one-process loss and within the
    training parity tolerance (`tests/test_torch_train.py`) of the
    reference's.

Summed case time under `-n 6 --dist loadfile` beside the tier-1 run's
heaviest files: 18 s on one intra-op thread (45 s on the default threads
in the whole tier-1 run), most of it the reference's compile of its
loss.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import narrow_params as jnarrow
from repro.core.formats import HBFPConfig as JHBFPConfig
from repro.data import batch_for_arch as jbatch
from repro.models import init_params as jinit_params
from repro.models.layers import Ctx as JCtx
from repro.models.transformer import loss_fn as jloss_fn
from repro.precision.policy import ResolvedPolicy as JResolvedPolicy
from repro_torch.configs import arch_ids, get_arch
from repro_torch.core import bfp
from repro_torch.core.formats import HBFPConfig
from repro_torch.kernels import hbfp_matmul as hm
from repro_torch.models import from_jax_params
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import _lookup, init_params, loss_fn
from repro_torch.precision import as_policy
from repro_torch.sharding import fwd_param_specs
from repro_torch.sharding.tensor_parallel import (CONCATENATED, GROUPS,
                                                  TPGroup, row_amax_needed,
                                                  tp_layout)
from repro_torch.train.train_step import _narrow_copy

F32_EPS = 2.0 ** -24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager ops, and ranks as threads: one intra-op thread keeps
    them from oversubscribing the cores that parallel test workers
    share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    def __init__(self, model):
        self.shape = {"data": 1, "model": model}
        self.axis_names = ("data", "model")


# -- ranks as threads ------------------------------------------------------------

class _Board:
    def __init__(self, n):
        self.n = n
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=120)


class ThreadTransport:
    """`launch.transport.Transport`'s collectives among the threads of one
    board, rank by rank in order."""

    def __init__(self, board, rank):
        self.board, self.rank, self.size = board, rank, board.n
        self.records = []

    def _exchange(self, t):
        b = self.board
        b.slots[self.rank] = t.detach().clone()
        b.barrier.wait()
        got = list(b.slots)
        b.barrier.wait()
        return got

    def all_reduce_(self, t, op=torch.distributed.ReduceOp.SUM):
        got = self._exchange(t)
        r = got[0].clone()
        for x in got[1:]:
            r = torch.maximum(r, x) if op == torch.distributed.ReduceOp.MAX \
                else torch.minimum(r, x) \
                if op == torch.distributed.ReduceOp.MIN else r + x
        t.copy_(r)
        return t

    def all_gather_dim(self, t, dim):
        return torch.cat(self._exchange(t), dim=dim)

    def reduce_scatter(self, t, dim, kind="all_reduce"):
        self.all_reduce_(t)
        k = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * k, k).clone()


def on_ranks(n, fn, sp=False):
    """fn(rank, TPGroup) on n threads; their results in rank order."""
    board = _Board(n)
    out, errs = [None] * n, []

    def run(r):
        try:
            out[r] = fn(r, TPGroup(ThreadTransport(board, r), sp))
        except BaseException as e:        # noqa: BLE001 (re-raised below)
            errs.append(e)
            board.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


# -- the row-amax quantizer --------------------------------------------------------

def _rows(shape, seed=0):
    """Activations whose rows span many binades, and some zero rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp2(rng.integers(-20, 20,
                                                          shape[:-1]))[..., None]
    x[..., 1, :] = 0.0
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("block", [None, 16])
def test_row_amax_parts_equal_whole_row(parts, block):
    x = _rows((3, 5, 128))
    cfg = HBFPConfig(8, 16, tile=32, act_block=block)
    whole = bfp.quantize_act(x, cfg)
    pieces = x.chunk(parts, dim=-1)
    need = row_amax_needed(block, 128 // parts, 128)
    assert need == (block is None)
    amax = torch.stack([p.abs().amax(-1, keepdim=True) for p in pieces]
                       ).amax(0) if need else None
    got = torch.cat([bfp.quantize_act(p, cfg, amax=amax) for p in pieces],
                    dim=-1)
    assert torch.equal(got.view(torch.int32), whole.view(torch.int32))
    if need:     # the local max alone gives another exponent somewhere
        local = torch.cat([bfp.quantize_act(p, cfg) for p in pieces], -1)
        assert not torch.equal(local, whole)


def test_row_amax_needed_refuses_a_cut_group():
    assert not row_amax_needed(128, 256, 512)
    assert row_amax_needed(None, 64, 128)
    assert row_amax_needed(128, 64, 128)
    with pytest.raises(ValueError, match="not whole rows"):
        row_amax_needed(128, 192, 384)


# -- B1-B3's plain versions ----------------------------------------------------------

M, K, N = 16, 256, 64


def _operands():
    x = _rows((M, K), 1)
    g = _rows((M, N), 2)
    w = bfp.quantize_weight(torch.randn(K, N, generator=torch.Generator()
                                        .manual_seed(3)),
                            HBFPConfig(8, 16, tile=16))
    return x, w, g


def _global_amax(parts):
    return torch.stack([p.abs().amax(-1) for p in parts]).amax(0)


@pytest.mark.parametrize("p", [2, 4])
def test_b3_row_amax_parts_bit_equal(p):
    """wgrad of a row-parallel product (x split on K) and of a
    column-parallel one (g split on N): each rank's dw and its dequantized
    operands are the one-process slices, bit for bit."""
    x, _, g = _operands()
    dw, xh, gh = hm.hbfp_wgrad(x, g, bk=K, bn=N, bm=M, operands=True)
    xs, gs = x.chunk(p, -1), g.chunk(p, -1)
    ax, ag = _global_amax(xs), _global_amax(gs)
    for i in range(p):
        k, n = K // p, N // p
        dwi, xhi, _ = hm.hbfp_wgrad(xs[i].contiguous(), g, bk=k, bn=N, bm=M,
                                    operands=True, x_amax=ax)
        assert torch.equal(xhi, xh[:, i * k:(i + 1) * k])
        assert torch.equal(dwi, dw[i * k:(i + 1) * k])
        dwj, _, ghj = hm.hbfp_wgrad(x, gs[i].contiguous(), bk=K, bn=n, bm=M,
                                    operands=True, g_amax=ag)
        assert torch.equal(ghj, gh[:, i * n:(i + 1) * n])
        assert torch.equal(dwj, dw[:, i * n:(i + 1) * n])


@pytest.mark.parametrize("p", [2, 4])
def test_b1_b2_row_amax_partial_sums(p):
    """B1 of a row-parallel product and B2 of a column-parallel one: the
    ranks' f32 partials, quantized on the global row amax, add up to the
    one-process product within 2·K·2⁻²⁴·(|x̂|·|w|) (the weights as
    narrowed, quantize_w off: the ranks' tiles are a part of the
    one-process tile)."""
    x, w, g = _operands()
    kw = dict(quantize_w=False)
    y = hm.hbfp_matmul_fwd(x, w, bk=K, bn=N, **kw)
    xh = hm.hbfp_wgrad(x, g, bk=K, bn=N, bm=M, operands=True)[1]
    xs, ws = x.chunk(p, -1), w.chunk(p, 0)
    ax = _global_amax(xs)
    parts = [hm.hbfp_matmul_fwd(xs[i].contiguous(), ws[i].contiguous(),
                                bk=K // p, bn=N, x_amax=ax, **kw)
             for i in range(p)]
    bound = 2 * K * F32_EPS * (xh.abs() @ w.abs())
    assert (sum(parts) - y).abs().le(bound).all()
    dx = hm.hbfp_dgrad(g, w, bk=K, bn=N, **kw)
    gh = hm.hbfp_wgrad(x, g, bk=K, bn=N, bm=M, operands=True)[2]
    gs, wc = g.chunk(p, -1), w.chunk(p, 1)
    ag = _global_amax(gs)
    parts = [hm.hbfp_dgrad(gs[i].contiguous(), wc[i].contiguous(), bk=K,
                           bn=N // p, g_amax=ag, **kw) for i in range(p)]
    bound = 2 * N * F32_EPS * (gh.abs() @ w.abs().T)
    assert (sum(parts) - dx).abs().le(bound).all()


@pytest.mark.parametrize("bk", [K, 64])
def test_own_row_amax_changes_nothing(bk):
    """[M] when a row is one group, [M, K/bk] per group."""
    x, w, g = _operands()
    own_x = x.abs().reshape(M, K // bk, bk).amax(-1).contiguous()
    own_g = g.abs().amax(-1)
    assert torch.equal(hm.hbfp_matmul_fwd(x, w, bk=bk, bn=N),
                       hm.hbfp_matmul_fwd(x, w, bk=bk, bn=N, x_amax=own_x))
    assert torch.equal(hm.hbfp_dgrad(g, w, bk=bk, bn=N),
                       hm.hbfp_dgrad(g, w, bk=bk, bn=N, g_amax=own_g))
    assert torch.equal(hm.hbfp_wgrad(x, g, bk=bk, bn=N, bm=M),
                       hm.hbfp_wgrad(x, g, bk=bk, bn=N, bm=M, x_amax=own_x,
                                     g_amax=own_g))


# -- the layout ------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4, 16])
@pytest.mark.parametrize("name", arch_ids())
def test_tile_aligned_layout(name, m):
    a = get_arch(name)
    meta = init_params(0, a, device="meta")
    lay = tp_layout(meta, FakeMesh(m), 128, a.n_heads, a.n_kv_heads)
    flat = dict(_flat(meta))
    specs = dict(_flat(fwd_param_specs(meta, FakeMesh(m))))
    base = lambda n: n.rsplit("/", 1)[-1]
    for n, d in lay.dims.items():
        t = flat[n]
        ref = next((i for i, s in enumerate(specs[n]) if s == "model"), None)
        if d is None:
            assert ref is None or lay.replicated[n], n
            continue
        assert d + t.ndim == ref, n
        if d >= -2:
            assert (t.shape[d] // m) % 128 == 0, n
    for group in GROUPS + CONCATENATED:
        names = [n for n in lay.dims if base(n) in group]
        assert len({lay.dims[n] is None for n in names}) <= 1, group
    for group in CONCATENATED:
        assert all(lay.dims[n] is None for n in lay.dims
                   if base(n) in group)
    rep = {base(n) for n in lay.replicated}
    if name == "gemma2-2b":
        assert rep == (set() if m < 16 else
                       {"attn_wq", "attn_wk", "attn_wv", "attn_wo",
                        "ffn_wg", "ffn_wi", "ffn_wo"})
    if name == "yi-9b":
        ffn = {"ffn_wg", "ffn_wi", "ffn_wo"}
        assert rep == (set() if m == 2 else ffn if m == 4 else
                       ffn | {"attn_wq", "attn_wk", "attn_wv", "attn_wo",
                              "embed_table", "head_w"})
        if m == 4:
            assert lay.replicated["layers/ffn_wg"] == \
                "11008 / 4 = 2752 cuts a 128-tile"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


# -- the vocab-parallel CE and embedding --------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_ce(n):
    rng = np.random.default_rng(4)
    logits = torch.from_numpy((rng.standard_normal((6, 3, 64)) * 4)
                              .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 64, (6, 3)))
    want_l = logits.clone().requires_grad_()
    want = torch.logsumexp(want_l, -1) - torch.gather(
        want_l, -1, labels[..., None]).squeeze(-1)
    want.sum().backward()

    def rank(r, tp):
        part = logits.chunk(n, -1)[r].clone().requires_grad_()
        loss = tp.vocab_ce(part, labels)
        loss.sum().backward()
        return loss.detach(), part.grad

    got = on_ranks(n, rank)
    for loss, _ in got:
        assert torch.allclose(loss, want.detach(), rtol=4 * F32_EPS,
                              atol=0)
    grad = torch.cat([g for _, g in got], -1)
    assert torch.allclose(grad, want_l.grad, rtol=0, atol=8 * F32_EPS)


@pytest.mark.parametrize("sp", [False, True])
def test_vocab_parallel_embedding(sp):
    table = torch.randn(64, 8).to(torch.bfloat16)
    tok = torch.randint(0, 64, (2, 8))

    def rank(r, tp):
        part = table.chunk(2, 0)[r].clone()
        part.tp_dim = -2
        return _lookup(part, tok, tp)

    got = on_ranks(2, rank, sp)
    want = table[tok]
    for r, x in enumerate(got):
        w = want.chunk(2, 1)[r] if sp else want
        assert torch.equal(x.view(torch.int16), w.view(torch.int16))


def _tp_part(narrow, lay, r, m):
    """Rank r's part of a one-process narrow copy, tagged as the mesh's
    narrow copy is."""
    def part(name, t):
        d = lay.dims.get(name)
        if d is None:
            return t
        k = t.shape[d] // m
        t = t.narrow(d, r * k, k).contiguous()
        t.tp_dim = d
        return t

    out = {k: part(k, v) for k, v in narrow.items() if k != "layers"}
    out["layers"] = [{k: part(f"layers/{k}", v) for k, v in lp.items()}
                     for lp in narrow["layers"]]
    return out


@pytest.mark.parametrize("sp", [False, True])
def test_first_loss_of_reference_weights(sp):
    ja = dataclasses.replace(jget_arch("gemma2-2b").smoke(),
                             dtype="float32")
    ta = dataclasses.replace(get_arch("gemma2-2b").smoke(), dtype="float32")
    jp = jinit_params(jax.random.key(0), ja)
    batch = jax.tree.map(np.asarray, jbatch(ja, 2, 32, step=0,
                                            kind="markov"))
    jcfg = JHBFPConfig(8, 16, tile=32)
    jctx = JCtx(policy=JResolvedPolicy(
        global_cfg=jcfg.with_(requantize_weights=False), backend="sim"))
    ref = float(jloss_fn(jnarrow(jp, jcfg), batch, ja, jctx)[0])
    cfg = HBFPConfig(8, 16, tile=32)
    pol = as_policy(cfg).resolve_segment(0)
    params = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    narrow = _narrow_copy(params, cfg.with_(requantize_weights=False),
                          torch.float32)
    with torch.no_grad():
        one = float(loss_fn(narrow, tb, ta,
                            Ctx(policy=pol, device="cpu"))[0])
    lay = tp_layout(init_params(0, ta, device="meta"), FakeMesh(2), 32,
                    ta.n_heads, ta.n_kv_heads)
    assert lay.replicated == {}

    def rank(r, tp):
        with torch.no_grad():
            return float(loss_fn(_tp_part(narrow, lay, r, 2), tb, ta,
                                 Ctx(policy=pol, device="cpu", tp=tp))[0])

    got = on_ranks(2, rank, sp)
    assert got == [one, one]
    assert abs(one - ref) <= 2e-3 * ref, (one, ref)
