"""Statistical parity of the port's stochastic rounding with the reference
(ROADMAP A5). The port draws from the xorshift stream and the reference
from threefry, so the draws differ; the noise they add is compared.

  * Weight narrowing: the same weights (≥ 10^5 elements) narrowed by the
    reference's `narrow_params` (a jax key) and the port's (an int key).
    Each package's error has a mean within 4 standard errors of 0, and
    the two error variances agree within 5% (their sampling spread at
    this size is ~0.3%).
  * The step-0 loss of gemma2 smoke on the reference's weights
    (`from_jax_train_state`), over 8 keys in each package: the two means
    differ by less than 4 standard errors of their difference, and each
    lies within the nearest-rounding parity tolerance of the reference's
    nearest loss (2e-3 relative, tests/test_torch_train.py) plus that
    spread.

Run on the CPU:
    PYTHONPATH=src python -m pytest tests/test_torch_sr_parity.py
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import HBFPConfig as JHBFPConfig
from repro.core.opt_shell import narrow_params as jnarrow
from repro.data.pipeline import batch_for_arch as jbatch
from repro.models import init_params as jinit_params
from repro.optim import make_schedule as jmake_schedule
from repro.train import init_train_state as jinit_train_state
from repro.train import make_step as jmake_step
from repro_torch.configs import get_arch
from repro_torch.core import HBFPConfig
from repro_torch.core.opt_shell import narrow_params
from repro_torch.kernels.common import fold_in
from repro_torch.optim import make_schedule
from repro_torch.train import from_jax_train_state, make_step

MEAN_SE = 4          # standard errors a mean may lie off its target
VAR_REL = 0.05       # error variances, relative
LOSS_TOL = 2e-3      # nearest-rounding loss parity, relative
KEYS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one intra-op thread avoids oversubscribing
    the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _errors(q, w) -> np.ndarray:
    return np.concatenate([(np.asarray(q[k], np.float64)
                            - np.asarray(w[k], np.float64)).reshape(-1)
                           for k in ("head_w", "layers")])


def test_narrowing_noise_matches_reference():
    rng = np.random.default_rng(21)
    w = {"head_w": rng.standard_normal((384, 256)).astype(np.float32),
         "layers": rng.standard_normal((2, 192, 384)).astype(np.float32)
         * 0.02}
    tree = lambda f: {"head_w": f(w["head_w"]),
                      "layers": {"ffn_wi": f(w["layers"])}}
    cfg = dict(mantissa_bits=4, wide_mantissa_bits=16, tile=24,
               rounding="stochastic")
    jq = jnarrow(tree(jax.numpy.asarray), JHBFPConfig(**cfg),
                 jax.random.key(5))
    tq = narrow_params(tree(torch.from_numpy), HBFPConfig(**cfg),
                       fold_in(0, 5))
    flat = lambda t: {"head_w": t["head_w"], "layers": t["layers"]["ffn_wi"]}
    ej, et = _errors(flat(jq), w), _errors(flat(tq), w)
    assert ej.size >= 10 ** 5 and not np.array_equal(ej, et)
    for e in (ej, et):
        assert abs(e.mean()) < MEAN_SE * e.std() / np.sqrt(e.size)
    assert abs(et.var() / ej.var() - 1) < VAR_REL
    # the noise is stochastic rounding's: larger than nearest rounding's
    nearest = narrow_params(tree(torch.from_numpy),
                            HBFPConfig(**{**cfg, "rounding": "nearest"}))
    assert et.var() > 1.2 * _errors(flat(nearest), w).var()


@pytest.mark.parametrize("spec", ["8~stochastic",
                                  "8~stochastic; backend=pallas"])
def test_step0_loss_over_keys_matches_reference(spec):
    ja = dataclasses.replace(jget_arch("gemma2-2b").smoke(),
                             dtype="float32", loss_chunk=32)
    ta = dataclasses.replace(get_arch("gemma2-2b").smoke(),
                             dtype="float32", loss_chunk=32)
    s0 = jinit_train_state(jax.random.key(0), ja, jinit_params)
    s0np = jax.tree.map(np.asarray, s0)
    batch = jax.tree.map(np.asarray, jbatch(ja, 2, 32, step=0,
                                            kind="markov"))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    kw = dict(base_lr=1e-3, warmup_steps=0, total_steps=10)
    jstep = jmake_step(ja, spec, jmake_schedule("constant", **kw))
    tstep = make_step(ta, spec, make_schedule("constant", **kw),
                      device="cpu")
    jl, tl = [], []
    for k in range(KEYS):
        _, m = jstep(s0, batch, jax.random.key(100 + k))
        jl.append(float(m["loss"]))
        loss, _, _ = tstep.grads(from_jax_train_state(s0np, device="cpu"),
                                 tbatch, fold_in(fold_in(0, 100), k))
        tl.append(float(loss))
    jl, tl = np.array(jl), np.array(tl)
    assert jl.std() > 0 and tl.std() > 0
    spread = MEAN_SE * np.sqrt(jl.var(ddof=1) / KEYS
                               + tl.var(ddof=1) / KEYS)
    assert abs(jl.mean() - tl.mean()) < spread
    _, m = jmake_step(ja, spec.replace("~stochastic", ""),
                      jmake_schedule("constant", **kw))(
        s0, batch, jax.random.key(0))
    nearest = float(m["loss"])
    for mean in (jl.mean(), tl.mean()):
        assert abs(mean - nearest) <= LOSS_TOL * nearest + spread
    print(f"{spec}: reference {jl.mean():.6f} ± {jl.std(ddof=1):.6f}, "
          f"port {tl.mean():.6f} ± {tl.std(ddof=1):.6f}, nearest "
          f"{nearest:.6f}")
