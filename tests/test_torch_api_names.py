"""Public names: every public top-level name of each reference module
that has a counterpart in the port exists there, but for the written
exemptions below, each with its reason; the reference modules with no
counterpart yet are pinned by name (none since the dry run's port,
ROADMAP slice 20). The reference's
names are read from its source (top-level functions, classes and
assignments, and the re-exports of its `__init__` files); the port's are
looked up on the imported module. The names added by ROADMAP A15 are
then held to the reference's behaviour.
"""
import ast
import importlib
import os
import re

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "src", "repro")
PORT = os.path.join(ROOT, "src", "repro_torch")

# reference modules without a port counterpart yet
NOT_PORTED = set()

_PALLAS = "a Pallas kernel entry; the port's kernel is the CUDA wrapper"
_INIT = ("the port builds parameters from shapes and loads the "
         "reference's weights through numpy (ROADMAP A15, not queued)")
_LANES = "jax fold_in sampling keys, which torch cannot replay (ROADMAP C5)"
_XLA = ("reads the TPU's interconnect or XLA's compiled dry-run artifacts; "
        "the port's dry run reads fake tensors and its transports' records "
        "(analysis/roofline.py: collective_bytes_from_records)")
# (module, name): why the port has no such name
EXEMPT = {
    ("kernels/hbfp_matmul.py", "hbfp_matmul_pallas"): _PALLAS,
    ("kernels/hbfp_matmul.py", "hbfp_dgrad_pallas"): _PALLAS,
    ("kernels/hbfp_matmul.py", "hbfp_wgrad_pallas"): _PALLAS,
    ("kernels/bfp_quantize.py", "bfp_quantize_pallas"): _PALLAS,
    ("kernels/ops.py", "INTERPRET"): "Pallas interpret mode; a CPU tensor "
    "takes the plain version",
    ("kernels/autotune.py", "vmem_bytes"): "the TPU's VMEM estimate",
    ("kernels/autotune.py", "VMEM_BUDGET_BYTES"): "the TPU's VMEM budget",
    ("kernels/linear.py", "seed_from_key"): "in kernels/common.py: the "
    "port's keys are host ints",
    ("models/attention.py", "init_attention"): _INIT,
    ("models/layers.py", "init_linear"): _INIT,
    ("models/moe.py", "init_moe"): _INIT,
    ("models/ssm.py", "init_ssm"): _INIT,
    ("models/xlstm.py", "init_mlstm"): _INIT,
    ("models/xlstm.py", "init_slstm"): _INIT,
    ("train/__init__.py", "make_scheduled_train_step"): "a deprecated alias "
    "of make_step (ROADMAP A15, not queued)",
    ("train/train_step.py", "make_scheduled_train_step"): "a deprecated "
    "alias of make_step (ROADMAP A15, not queued)",
    ("serve/__init__.py", "sample_one"): _LANES,
    ("serve/__init__.py", "lane_key"): _LANES,
    ("serve/sampling.py", "sample_one"): _LANES,
    ("serve/sampling.py", "lane_key"): _LANES,
    ("analysis/roofline.py", "ICI_BW_PER_LINK"): _XLA + " (the H100's "
    "link is NVLINK_BW_PER_DIR)",
    ("analysis/roofline.py", "cost_analysis_dict"): _XLA,
    ("analysis/roofline.py", "collective_bytes_from_text"): _XLA,
}


def _ref_modules():
    out = []
    for root, _, files in os.walk(REF):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), REF))
    return sorted(out)


def _public_names(path: str, init: bool) -> set:
    """Top-level functions, classes and assigned names of a source file
    (and its `from ... import` names when it is a package's `__init__`)."""
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif init and isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _port_module(rel: str) -> str:
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["repro_torch", *parts])


PORTED = [m for m in _ref_modules()
          if os.path.exists(os.path.join(PORT, m))]


def test_modules_without_a_counterpart_are_pinned():
    missing = {m for m in _ref_modules()
               if not os.path.exists(os.path.join(PORT, m))}
    assert missing == NOT_PORTED


@pytest.mark.parametrize("rel", PORTED)
def test_public_names_exist_in_port(rel):
    names = _public_names(os.path.join(REF, rel),
                          rel.endswith("__init__.py"))
    mod = importlib.import_module(_port_module(rel))
    missing = sorted(n for n in names
                     if (rel, n) not in EXEMPT and not hasattr(mod, n))
    assert missing == [], f"{rel}: {missing}"


def test_every_exemption_is_still_needed():
    """An exempt name that the port now has, or that the reference no
    longer has, leaves the list."""
    for (rel, name), why in EXEMPT.items():
        assert why
        assert name in _public_names(os.path.join(REF, rel),
                                     rel.endswith("__init__.py")), rel
        mod = importlib.import_module(_port_module(rel))
        assert not hasattr(mod, name), (rel, name)


def test_formats_resolve_and_t24():
    from repro.core import formats as jf
    from repro.core.schedule_precision import from_spec as jfrom_spec
    from repro_torch import core
    from repro_torch.core.schedule_precision import from_spec
    assert core.FP32 is None and core.resolve(None) is None
    for f in ("mantissa_bits", "wide_mantissa_bits", "tile", "act_block",
              "rounding"):
        assert getattr(core.HBFP8_16_T24, f) == getattr(jf.HBFP8_16_T24, f)
    assert core.HBFP8_16_T24.name == jf.HBFP8_16_T24.name
    assert core.resolve(core.HBFP8_16_T24) is core.HBFP8_16_T24
    for step, layer in ((0, None), (60, "layers.0.wq"), (99, "head_w")):
        got = core.resolve(from_spec("4@0,8@50%", total_steps=100), step,
                           layer)
        want = jf.resolve(jfrom_spec("4@0,8@50%", total_steps=100), step,
                          layer)
        assert got.mantissa_bits == want.mantissa_bits
    with pytest.raises(TypeError, match="not a precision spec"):
        core.resolve(8)


def test_page_pool_owned_matches_reference():
    from repro.serve.paged_cache import PagePool as JPool
    from repro_torch.serve.paged_cache import PagePool
    pools = (PagePool(8, 16), JPool(8, 16))
    for p in pools:
        p.alloc(3, 2)
        p.alloc(5, 3)
        p.alloc(3, 1)
        p.free(5)
        p.alloc(7, 2)
    for rid in (3, 5, 7, 9):
        assert pools[0].owned(rid) == pools[1].owned(rid)
    got = pools[0].owned(3)
    got.append(99)                      # a copy: the pool is unchanged
    assert pools[0].owned(3) == pools[1].owned(3)


def test_neg_inf_values_match_reference():
    from repro.kernels import hbfp_flash_attn as jfa
    from repro.serve import sampling as jsamp
    from repro_torch.kernels import hbfp_flash_attn as tfa
    from repro_torch.serve import sampling as tsamp
    assert tfa.NEG_INF == jfa.NEG_INF
    assert tsamp.NEG_INF == float(jsamp.NEG_INF) == float("-inf")


def test_flash_attention_vjp_is_the_training_function():
    """flash_attention_vjp(spec, q, k, v) on the CPU: the FlashAttention
    Function's output and grads (B4, then B5 and B6, plain versions)."""
    from repro_torch.kernels.hbfp_flash_attn import (FlashAttention,
                                                     FlashSpec,
                                                     flash_attention_vjp)
    rng = np.random.default_rng(9)
    spec = FlashSpec(m_bits=8, bq=32, bk=32, causal=True)
    qkv = [torch.from_numpy(rng.standard_normal((2, 64, 32))
                            .astype(np.float32)) for _ in range(3)]
    do = torch.from_numpy(rng.standard_normal((2, 64, 32))
                          .astype(np.float32))
    outs = []
    for fn in (flash_attention_vjp, FlashAttention.apply):
        args = [t.clone().requires_grad_() for t in qkv]
        o = fn(spec, *args)
        o.backward(do)
        outs.append([o.detach()] + [a.grad for a in args])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert np.isfinite(outs[0][0].numpy()).all()


def test_dryrun_names_match_reference():
    """The dry run's public names are the reference's, its shapes and skip
    rule equal, and its CLI takes every one of the reference's flags."""
    from repro.launch import dryrun as jdry
    from repro_torch.launch import dryrun
    names = _public_names(os.path.join(REF, "launch", "dryrun.py"), False)
    assert {"SHAPES", "FULL_ATTENTION_SKIP", "build_cell", "applicable",
            "run_cell", "main"} <= names
    assert all(hasattr(dryrun, n) for n in names)
    assert dryrun.SHAPES == jdry.SHAPES
    assert dryrun.FULL_ATTENTION_SKIP == jdry.FULL_ATTENTION_SKIP
    src = open(os.path.join(REF, "launch", "dryrun.py")).read()
    flags = set(re.findall(r'add_argument\("(--[a-z0-9-]+)"', src))
    port = open(os.path.join(PORT, "launch", "dryrun.py")).read()
    assert flags <= set(re.findall(r'add_argument\("(--[a-z0-9-]+)"', port))
