"""The port's roofline terms (`repro_torch.analysis.roofline`) and the dry
run's report tables (`repro_torch.analysis.report`) against the
reference's. The reference computes with the TPU's peaks; with its
constants swapped for the port's H100 figures (bf16 and HBM peaks, the
NVLink rate in the ICI link's place) its `roofline_terms`, `model_flops`
and `summarize` give the port's numbers and text. The two tables print
the reference's text for one synthetic dry-run record set, but that the
memory table asks whether a cell fits one H100's 80 GiB and the roofline
table's remedies name Hopper's (int8 `wgmma`, shared memory, NVLink).
"""
import pytest

from repro.analysis import report as jrep
from repro.analysis import roofline as jroof
from repro.configs import arch_ids as jarch_ids
from repro.configs import get_arch as jget_arch
from repro_torch.analysis import report as trep
from repro_torch.analysis import roofline as troof
from repro_torch.configs import get_arch

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k", "other")


@pytest.fixture
def h100_reference(monkeypatch):
    """The reference's roofline module on the port's constants."""
    monkeypatch.setattr(jroof, "PEAK_FLOPS_BF16", troof.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jroof, "HBM_BW", troof.HBM_BW)
    monkeypatch.setattr(jroof, "ICI_BW_PER_LINK", troof.NVLINK_BW_PER_DIR)
    return jroof


def test_h100_constants():
    """NVIDIA's H100 SXM data sheet (PERF.md §3), not the TPU's."""
    assert troof.PEAK_FLOPS_BF16 == 989e12
    assert troof.PEAK_FLOPS_INT8 == 1979e12
    assert troof.HBM_BW == 3.35e12
    assert troof.NVLINK_BW_PER_DIR == 450e9
    assert not hasattr(troof, "ICI_BW_PER_LINK")


@pytest.mark.parametrize("arch", list(jarch_ids()))
def test_model_flops_match_reference(arch):
    for shape in SHAPES:
        assert troof.model_flops(get_arch(arch), shape) == \
            jroof.model_flops(jget_arch(arch), shape)


CASES = [dict(flops=989e12, bytes_hbm=3.35e12 * 2, bytes_coll=1e6,
              n_chips=1),
         dict(flops=4e15, bytes_hbm=1e12, bytes_coll=9e11, n_chips=256,
              shape_name="train_4k"),
         dict(flops=1e9, bytes_hbm=1e9, bytes_coll=5e12, n_chips=512,
              shape_name="decode_32k"),
         dict(flops=0.0, bytes_hbm=0.0, bytes_coll=0.0, n_chips=16,
              shape_name="prefill_32k")]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_roofline_terms_match_reference(h100_reference, case):
    kw = dict(CASES[case])
    name = kw.get("shape_name")
    for peak in (troof.PEAK_FLOPS_BF16, troof.PEAK_FLOPS_INT8):
        got = troof.roofline_terms(
            **kw, arch=None if name is None else get_arch("gemma2-2b"),
            peak_flops=peak)
        want = h100_reference.roofline_terms(
            **kw, arch=None if name is None else jget_arch("gemma2-2b"),
            peak_flops=peak)
        assert got == want


def test_bottleneck_on_h100():
    r = troof.roofline_terms(flops=989e12, bytes_hbm=3.35e12 * 2,
                             bytes_coll=1e6, n_chips=1)
    assert r["bottleneck"] == "memory"
    assert r["memory_s"] == 2.0 and r["compute_s"] == 1.0


def _results():
    """A synthetic dry-run results dict: every bottleneck × kind pair the
    fixes name, a cell past 16 GiB (fits the H100, not the v5e), one past
    80 GiB, a skipped and an error cell."""
    out = {}
    arch = get_arch("yi-9b")
    terms = {"compute": (3e16, 1e9, 1e6), "memory": (1e9, 4e13, 1e6),
             "collective": (1e9, 1e9, 6e12)}
    for i, (bound, (f, b, c)) in enumerate(terms.items()):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            r = troof.roofline_terms(flops=f, bytes_hbm=b, bytes_coll=c,
                                     n_chips=256, arch=arch,
                                     shape_name=shape)
            assert r["bottleneck"] == bound
            gib = (4.0, 42.5, 96.25)[i]
            out[f"yi-9b|{shape}|{bound}"] = {
                "arch": "yi-9b", "shape": shape, "mesh": "single",
                "status": "ok", "roofline": r,
                "memory": {"argument_bytes": int(gib * 2**29),
                           "temp_bytes": int(gib * 2**29),
                           "per_device_total_gib": gib}}
    out["xlstm-350m|long_500k|single"] = {
        "arch": "xlstm-350m", "shape": "long_500k", "mesh": "single",
        "status": "skipped", "reason": "assignment rule"}
    out["yi-9b|long_500k|multi"] = {"arch": "yi-9b", "shape": "long_500k",
                                    "mesh": "multi", "status": "error",
                                    "error": "OOM"}
    return out


def test_summarize_matches_reference(h100_reference):
    res = _results()
    assert troof.summarize(res) == h100_reference.summarize(res)
    assert troof.summarize(res, "train_4k") == \
        h100_reference.summarize(res, "train_4k")


def _cells(line):
    return [c.strip() for c in line.strip().strip("|").split("|")]


def test_memory_table_matches_reference_on_h100():
    res = _results()
    got = trep.memory_table(res).split("\n")
    want = jrep.memory_table(res).split("\n")
    assert len(got) == len(want) == 2 + 9
    assert got[0] == want[0].replace("fits v5e 16G", "fits H100 80G")
    assert got[1] == want[1]
    for g, w in zip(got[2:], want[2:]):
        g, w = _cells(g), _cells(w)
        assert g[:-1] == w[:-1]
        assert g[-1] == ("yes" if float(g[-2]) <= 80 else "**no**")
    assert {_cells(g)[-1] for g in got[2:]} == {"yes", "**no**"}


def test_roofline_table_matches_reference_but_remedies():
    res = _results()
    got = trep.roofline_table(res).split("\n")
    want = jrep.roofline_table(res).split("\n")
    assert len(got) == len(want)
    assert got[:2] == want[:2] and got[-1] == want[-1]   # header, skips
    fixes = set()
    for g, w in zip(got[2:-1], want[2:-1]):
        assert _cells(g)[:-1] == _cells(w)[:-1]
        fixes.add(_cells(g)[-1])
    text = " ".join(fixes)
    for hopper in ("wgmma", "shared memory", "NVLink"):
        assert hopper in text
    for tpu in ("MXU", "VMEM", "ICI"):
        assert tpu not in text


def test_render_dryrun_matches_reference(tmp_path, capsys, monkeypatch):
    import json
    res = _results()
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(res))
    trep.render_dryrun(str(path))
    got = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["report", str(path)])
    jrep.main()
    want = capsys.readouterr().out
    assert got.split("### Memory")[0] == want.split("### Memory")[0]
    assert got.strip().split("\n")[-1] == want.strip().split("\n")[-1]
    assert "ERROR yi-9b|long_500k|multi: OOM" in got
