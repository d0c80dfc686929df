"""The port's roofline (``repro_torch.roofline``) against ``repro.roofline``:
``test_roofline.py``'s cases on the port with the H100 spec; the three terms,
the model flops and the token counts equal to the reference's on the same
records and the same ``HWSpec`` numbers; ``collective_stats`` over the
collective log equal to the reference's over HLO text holding the same
collectives; the broadcast rule; and the report's sections, the same text
as the reference's over one directory of records."""
import dataclasses
import json

import numpy as np
import pytest

from repro.roofline import analysis as janalysis
from repro.roofline import hlo as jhlo
from repro.roofline import report as jreport
from repro_torch.roofline import analysis, collectives, report
from repro_torch.roofline.analysis import H100, HWSpec, model_flops, roofline_terms

HLO = """
HloModule jit_step
%x = f32[128,512]{1,0} parameter(0)
%all-gather = f32[128,512]{0,1} all-gather(%conv), channel_id=1, replica_groups=[2,4]<=[8], dimensions={1}
%all-reduce = f32[64]{0} all-reduce(%wrapped), channel_id=2, replica_groups=[2,4]<=[8], use_global_device_ids=true
%reduce-scatter = bf16[32,16]{1,0} reduce-scatter(%y), channel_id=3, replica_groups=[1,8]<=[8], dimensions={0}
%all-to-all = bf16[8,64]{1,0} all-to-all(%z), channel_id=4, replica_groups={{0,1,2,3}}, dimensions={0}
%collective-permute = f32[16]{0} collective-permute(%w), channel_id=5, source_target_pairs={{0,1}}
%fusion = f32[4,4]{1,0} fusion(%all-reduce), kind=kLoop
"""
# the same collectives as (kind, result bytes, group size) events
EVENTS = [
    ("all-gather", 128 * 512 * 4, 4),
    ("all-reduce", 64 * 4, 4),
    ("reduce-scatter", 32 * 16 * 2, 8),
    ("all-to-all", 8 * 64 * 2, 4),
    ("collective-permute", 16 * 4, 1),
]


def jspec(hw: HWSpec):
    """The reference's ``HWSpec`` with ``hw``'s numbers."""
    return janalysis.HWSpec(**dataclasses.asdict(hw))


def test_h100_spec_is_the_datasheet():
    assert H100.name == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert (H100.peak_flops, H100.hbm_bw) == (989e12, 3.35e12)
    assert H100.ici_links * H100.ici_link_bw == 450e9  # NVLink 4: 18 x 25 GB/s
    assert not hasattr(analysis, "V5E")


def test_collective_stats_kinds_and_wire_factors():
    st = collectives.collective_stats(EVENTS)
    k = st["by_kind"]
    assert set(k) == {"all-gather", "all-reduce", "reduce-scatter",
                      "all-to-all", "collective-permute"}
    ag = 128 * 512 * 4
    assert k["all-gather"]["result_bytes"] == ag
    np.testing.assert_allclose(k["all-gather"]["wire_bytes"], ag * 3 / 4)
    ar = 64 * 4
    np.testing.assert_allclose(k["all-reduce"]["wire_bytes"], 2 * ar * 3 / 4)
    rs = 32 * 16 * 2
    np.testing.assert_allclose(k["reduce-scatter"]["wire_bytes"], rs * 7)
    a2a = 8 * 64 * 2
    np.testing.assert_allclose(k["all-to-all"]["wire_bytes"], a2a * 3 / 4)
    cp = 16 * 4
    np.testing.assert_allclose(k["collective-permute"]["wire_bytes"], cp)
    assert st["total_result_bytes"] == ag + ar + rs + a2a + cp


def test_collective_stats_equals_reference_on_the_same_collectives():
    assert collectives.collective_stats(EVENTS) == jhlo.collective_stats(HLO)
    assert collectives.collective_stats([]) == jhlo.collective_stats("")


def test_collective_stats_prices_totals_as_their_calls():
    """The mesh layer's totals ({(kind, group size): [calls, bytes]}) price
    as the calls they sum, one by one."""
    calls = EVENTS * 3
    totals: dict = {}
    for kind, nbytes, g in calls:
        t = totals.setdefault((kind, g), [0, 0])
        t[0] += 1
        t[1] += nbytes
    got, want = collectives.collective_stats(totals), collectives.collective_stats(calls)
    assert got["total_result_bytes"] == want["total_result_bytes"]
    np.testing.assert_allclose(got["total_wire_bytes"], want["total_wire_bytes"], rtol=1e-12)
    assert got["by_kind"].keys() == want["by_kind"].keys()
    for kind, ent in want["by_kind"].items():
        assert got["by_kind"][kind]["count"] == ent["count"]
        assert got["by_kind"][kind]["result_bytes"] == ent["result_bytes"]
        np.testing.assert_allclose(got["by_kind"][kind]["wire_bytes"], ent["wire_bytes"],
                                   rtol=1e-12)


def test_collective_stats_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown collective kind"):
        collectives.collective_stats([("all-gatherv", 8, 2)])


@pytest.mark.parametrize("g", [1, 2, 4, 16, 32])
@pytest.mark.parametrize("out_bytes", [4096, 3 * 2**20])
def test_broadcast_rule_makes_whole_at_all_gathers_price(g, out_bytes):
    """A tensor made whole from g slices by g broadcasts, one slice each,
    costs (g-1)/g of its bytes a device: an all-gather's wire bytes."""
    events = [("broadcast", out_bytes // g, g)] * g
    st = collectives.collective_stats(events)
    want = jhlo.collective_stats(
        f"%ag = u8[{out_bytes}]{{0}} all-gather(%x), replica_groups=[1,{g}]<=[{g}]")
    np.testing.assert_allclose(st["total_wire_bytes"], want["total_wire_bytes"], rtol=1e-15)
    assert st["by_kind"]["broadcast"]["count"] == g


def _record(flops=1e15, mem=1e12, wire=1e11, kind="train", n_active=20e9,
            shape="train_4k"):
    return {
        "kind": kind,
        "shape": shape,
        "n_devices": 256,
        "cost": {"flops": flops, "bytes_accessed": mem},
        "collectives": {"total_wire_bytes": wire},
        "model": {"n_params": n_active, "n_active_params": n_active},
    }


def test_roofline_terms_bounds():
    hw = H100
    t = roofline_terms(_record(), hw)
    np.testing.assert_allclose(t["compute_s"], 1e15 / hw.peak_flops)
    np.testing.assert_allclose(t["memory_s"], 1e12 / hw.hbm_bw)
    np.testing.assert_allclose(t["collective_s"], 1e11 / (hw.ici_links * hw.ici_link_bw))
    assert t["bound"] == "compute"
    t2 = roofline_terms(_record(flops=1e12, wire=1e13), hw)
    assert t2["bound"] == "collective"
    t3 = roofline_terms(_record(flops=1e12, mem=1e13, wire=1e7), hw)
    assert t3["bound"] == "memory"


def test_model_flops_train_vs_decode():
    assert model_flops(_record()) == 6.0 * 20e9 * 256 * 4096
    assert model_flops(_record(kind="decode", shape="decode_32k")) == 2.0 * 20e9 * 128


def test_roofline_fraction_sane():
    t = roofline_terms(_record())
    assert 0 < t["roofline_fraction"] <= 1.5
    assert 0 < t["useful_flops_ratio"] < 100


RECORDS = [
    _record(),
    _record(flops=3e12, mem=7e13, wire=2e9, kind="prefill", shape="prefill_32k"),
    _record(flops=1e12, mem=1e13, wire=4e11, kind="decode", shape="decode_32k",
            n_active=37e9),
    _record(flops=0.0, mem=1.0, wire=0.0, kind="decode", shape="long_500k"),
]


@pytest.mark.parametrize("i", range(len(RECORDS)))
@pytest.mark.parametrize("hw", [H100, HWSpec("other", 1e15, 2e12, 50e9, 4)],
                         ids=["h100", "other"])
def test_terms_equal_reference(i, hw):
    rec = RECORDS[i]
    assert roofline_terms(rec, hw) == janalysis.roofline_terms(rec, jspec(hw))
    assert model_flops(rec) == janalysis.model_flops(rec)
    assert analysis.tokens_of(rec["shape"], rec) == janalysis.tokens_of(rec["shape"], rec)


def _full(arch, shape, mesh, kind, i):
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "kind": kind, "status": "ok",
        "n_devices": 256 if mesh == "pod16x16" else 512,
        "memory": {"argument_bytes": 2**30 * (i + 1), "temp_bytes": 3 * 2**29 * i,
                   "output_bytes": 8, "alias_bytes": 2**30},
        "cost": {"flops": 1.5e14 * (i + 1), "bytes_accessed": 2.5e12 * (i + 2)},
        "collectives": {"total_wire_bytes": 4.25e9 * i, "total_result_bytes": 1},
        "compile_s": 1.25 * i,
        "fallbacks": [{"tensor": f"segments/0/attn/w{i}", "axis": "heads", "dim": 2,
                       "why": f"dim {40 + i} not divisible by mesh axis 'model'=16"},
                      {"tensor": "embed/table", "axis": "vocab", "dim": 0,
                       "why": "dim 92553 not divisible"}],
        "model": {"n_params": 1e9 * (i + 1), "n_active_params": 5e8 * (i + 1)},
    }


@pytest.fixture
def artifacts(tmp_path):
    recs = []
    for i, (arch, shape, kind) in enumerate([
            ("rwkv6-3b", "train_4k", "train"), ("rwkv6-3b", "decode_32k", "decode"),
            ("olmoe-1b-7b", "prefill_32k", "prefill"), ("hymba-1.5b", "long_500k", "decode")]):
        for mesh in ("pod16x16", "pod2x16x16"):
            recs.append(_full(arch, shape, mesh, kind, i))
    recs.append({"arch": "mistral-nemo-12b", "shape": "long_500k", "mesh": "pod16x16",
                 "kind": "decode", "status": "skipped", "reason": "pure full-attention"})
    recs.append({"arch": "deepseek-67b", "shape": "train_4k", "mesh": "pod16x16",
                 "status": "error", "error": "RuntimeError: out of luck " * 5})
    for r in recs:
        name = f"{r['arch']}__{r['shape']}__{r['mesh']}.json"
        (tmp_path / name).write_text(json.dumps(r))
    return tmp_path


def test_report_sections_equal_reference(artifacts, monkeypatch):
    d = str(artifacts)
    monkeypatch.setattr(jreport, "DRY", d)
    got = report.dryrun_section(d)
    assert got == jreport.dryrun_section()
    assert got.startswith("**8 cells compiled**, 1 skipped")
    assert report.fallback_section(d) == jreport.fallback_section()
    for hw in (H100, HWSpec("other", 1e15, 2e12, 50e9, 4)):
        for mesh in ("pod16x16", "pod2x16x16"):
            assert analysis.table(d, mesh=mesh, hw=hw) == \
                janalysis.table(d, mesh=mesh, hw=jspec(hw))
    assert report.roofline_section(d) == analysis.table(d, mesh="pod16x16", hw=H100)


def test_report_perf_section_and_main(artifacts, tmp_path, capsys):
    perf = tmp_path / "perf"
    perf.mkdir()
    rec = dict(_full("olmoe-1b-7b", "train_4k", "pod16x16", "train", 2), label="C0_baseline")
    (perf / "C0_baseline.json").write_text(json.dumps(rec))
    (perf / "C1_qchunk.json").write_text(json.dumps({"label": "C1_qchunk", "status": "error"}))
    text = report.perf_section(str(perf))
    lines = text.splitlines()
    assert lines[2].startswith("| C0_baseline | ") and "| error |" in lines[3]
    assert report.perf_section(str(tmp_path / "none")).startswith("(run repro_torch")
    report.main(["--dryrun-dir", str(artifacts), "--perf-dir", str(perf)])
    out = capsys.readouterr().out
    assert "## Generated: dry-run summary" in out and "C0_baseline" in out
