"""The port's precision schedules and policies against the JAX package.

`repro_torch.core.schedule_precision` and `repro_torch.precision` are
plain-Python copies of the reference's modules. For every spec string of
the reference's policy and schedule tests, the port parses the same
segments (or raises the same exception), resolves every (site, role,
step) to the same format and source, and serializes to the same meta
dict, in both directions.
"""
import dataclasses
import json

import pytest

from repro.core import HBFPConfig as JHBFPConfig
from repro.core import schedule_precision as jsp
from repro.precision import PrecisionPolicy as JPolicy
from repro.precision import QuantSite as JSite
from repro.precision import parse_policy as jparse
from repro_torch.core import HBFPConfig
from repro_torch.core import schedule_precision as sp
from repro_torch.precision import PrecisionPolicy, QuantSite, parse_policy

NAMES = ("layers/attn_wq", "layers/ffn_wg", "layers/ffn_wg2", "lm_head",
         "head_w", "tok_embed", "x")
ROLES = ("fwd", "dgrad", "wgrad", "attn_qk", "attn_pv")
STEPS = (0, 1, 7, 8, 9, 10, 11, 12, 29, 30, 31, 50, 90, 99, 100, 101, 899,
         900, 950, 10 ** 6)

# (spec, total_steps, base kwargs or None)
POLICY_SPECS = [
    ("8", None, None), ("12", None, None), ("fp32", None, None),
    ("8~stochastic", None, None),
    ("4@0,8@100; wgrad+2; lm_head:12", None, None),
    ("4@0,8@90%; wgrad+2; dgrad=8; embed:fp32; lm_head:8; backend=pallas",
     1000, None),
    ("4@0,8@30; wgrad+2; lm_head:12; backend=pallas", None, None),
    ("8@0,4@10; lm_head:12", None, dict(mantissa_bits=8,
                                        wide_mantissa_bits=8, tile=24)),
    ("4; wgrad+4", None, dict(mantissa_bits=4, tile=24)),
    ("4; wgrad+4; backend=pallas", None, dict(mantissa_bits=4, tile=24)),
    ("8; attn_qk=4; backend=pallas", None, None),
    ("4; lm_head:12", None, None),
    ("4@0,8@12; b=16@0,b=32@8", 20, None),
    ("4@0,8@90%; b=16@0,b=64@50%; wgrad+2", 100, None),
    ("4@0,8@90%", 100, None), ("8; b=16@0,b=64@50%", 100, None),
    ("8; b=16", None, None), ("8; b=32; backend=pallas", None, None),
    ("8; lm_head:12; wgrad+2; b=16; backend=pallas", None, None),
    ("8; wgrad+2; dgrad=10", None, None), ("8~stochastic; ffn:fp32", None,
                                           None),
    ("12@0,4@200~stochastic", None, None), ("fp32@0,8@10", None, None),
    ("8; fwd+2", None, None), ("8; wgrad*2", None, None),
    ("8; backend=cuda", None, None), ("8; b=16; b=32", None, None),
    ("4,8", None, None), ("8@50%", None, None), ("", None, None),
    ("8; b=16,b=32", None, None),
]

# (spec, total_steps, base kwargs or None, overrides) for from_spec
SCHEDULE_SPECS = [
    ("4@0,8@90%,16@95%", 1000, None, ()),
    ("12@0,4@200~stochastic", None, None, ()),
    ("fp32@0,8@10", None, None, ()),
    ("fp32@0,8@100", None, dict(mantissa_bits=8, tile=24),
     (("lm_head", 12),)),
    ("8", None, None, (("lm_head", 12), ("embed", None))),
    ("8@50%", None, None, ()), ("4,8", None, None, ()),
    ("6@5", None, None, ()), ("8~exact", None, None, ()),
]


def _d(cfg):
    return None if cfg is None else dataclasses.asdict(cfg)


def _parse(fn, *a, **k):
    try:
        return fn(*a, **k), None
    except Exception as e:     # the exception itself is compared
        return None, type(e)


def _seg_table(seg):
    return (_d(seg.global_cfg),
            [(f, _d(c)) for f, c in seg.layer_overrides],
            [(n, _d(c)) for n, c in seg.controller_overrides],
            [(r.role, r.delta, r.bits) for r in seg.role_widths],
            seg.backend, seg.is_fp32, seg.has_overrides, seg.any_stochastic)


@pytest.mark.parametrize("spec,total,base", POLICY_SPECS,
                         ids=[repr(s[0]) for s in POLICY_SPECS])
def test_policy_resolution_equals_reference(spec, total, base):
    j, jerr = _parse(jparse, spec, total_steps=total,
                     base=None if base is None else JHBFPConfig(**base))
    t, terr = _parse(parse_policy, spec, total_steps=total,
                     base=None if base is None else HBFPConfig(**base))
    assert jerr is terr
    if j is None:
        return
    assert t.boundaries() == j.boundaries()
    assert t.num_segments == j.num_segments and t.name == j.name
    assert t.to_dict() == j.to_dict()
    for i in range(j.num_segments):
        assert _seg_table(t.resolve_segment(i)) == \
            _seg_table(j.resolve_segment(i))
    ctrl = (("layers/ffn_wg", 8), ("head_w@wgrad", 12),
            ("layers/attn_wq", {"m": None, "b": 8}))
    for step in STEPS:
        assert t.segment_index(step) == j.segment_index(step)
        assert t.block_at(step) == j.block_at(step)
        assert _d(t.format(step)) == _d(j.format(step))
        tseg = t.resolve_segment(t.segment_index(step)).with_controller(ctrl)
        jseg = j.resolve_segment(j.segment_index(step)).with_controller(ctrl)
        for name in NAMES:
            for role in ROLES:
                tq = t.resolve(QuantSite(name, role), step)
                jq = j.resolve(JSite(name, role), step)
                assert (_d(tq.cfg), tq.backend, tq.source) == \
                    (_d(jq.cfg), jq.backend, jq.source), (name, role, step)
                tq, jq = tseg.resolve(QuantSite(name, role)), \
                    jseg.resolve(JSite(name, role))
                assert (_d(tq.cfg), tq.source) == (_d(jq.cfg), jq.source)
    # meta round trip both ways
    meta = json.loads(json.dumps(t.to_dict()))
    assert PrecisionPolicy.from_dict(meta) == t
    assert JPolicy.from_dict(meta).to_dict() == j.to_dict()
    assert sp.precision_from_dict(json.loads(json.dumps(
        jsp.precision_to_dict(j)))) == t


@pytest.mark.parametrize("spec,total,base,overrides", SCHEDULE_SPECS,
                         ids=[repr(s[0]) for s in SCHEDULE_SPECS])
def test_schedule_resolution_equals_reference(spec, total, base, overrides):
    j, jerr = _parse(jsp.from_spec, spec, total_steps=total,
                     base=None if base is None else JHBFPConfig(**base),
                     overrides=overrides)
    t, terr = _parse(sp.from_spec, spec, total_steps=total,
                     base=None if base is None else HBFPConfig(**base),
                     overrides=overrides)
    assert jerr is terr
    if j is None:
        return
    assert t.boundaries() == j.boundaries() and t.name == j.name
    assert t.to_dict() == j.to_dict()
    for step in STEPS:
        assert t.segment_index(step) == j.segment_index(step)
        for name in (None,) + NAMES:
            assert _d(t.resolve(step, name)) == _d(j.resolve(step, name))
    assert sp.PrecisionSchedule.from_dict(
        json.loads(json.dumps(t.to_dict()))) == t


def test_schedule_constructors_equal_reference():
    base = dict(mantissa_bits=8, tile=24)
    pairs = [
        (sp.staircase(((0, 4), (10, 8), (20, 16)), base=HBFPConfig(**base)),
         jsp.staircase(((0, 4), (10, 8), (20, 16)),
                       base=JHBFPConfig(**base))),
        (sp.warmup_then_narrow(16, 8, 10, base=HBFPConfig(8, 8)),
         jsp.warmup_then_narrow(16, 8, 10, base=JHBFPConfig(8, 8))),
        (sp.as_schedule(HBFPConfig(12, 16)),
         jsp.as_schedule(JHBFPConfig(12, 16))),
        (sp.constant(None, overrides=(("lm_head", HBFPConfig(12, 16)),)),
         jsp.constant(None, overrides=(("lm_head", JHBFPConfig(12, 16)),))),
    ]
    for t, j in pairs:
        assert t.to_dict() == j.to_dict()
        for step in STEPS:
            for name in (None, "lm_head", "x"):
                assert _d(t.resolve(step, name)) == _d(j.resolve(step, name))
    for bad in (dict(segments=()), dict(segments=((5, None),))):
        with pytest.raises(ValueError):
            sp.PrecisionSchedule(**bad)
    with pytest.raises(ValueError):
        sp.staircase(((0, 4), (10, 8), (10, 16)))
