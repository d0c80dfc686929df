"""The port's dry-run (``repro_torch.launch.dryrun``): the CLI on one cell
in a subprocess, as ``test_dryrun_integration.py`` runs the reference's; the
flop, byte and memory counters against hand arithmetic; the full-depth
count against the reference's layer extrapolation applied to the port's own
1- and 2-layer counts; each architecture's parameter fallbacks on the
(16 x 16) mesh against the reference's resolver; rwkv6-3b's train_4k
flops a device on 512 ranks against 256, run live; the dry-run's grouped
WKV form against the per-chunk form; and the mesh layer's collective
totals, which stay of one size however many collectives it issues.

The cells that need the fake process group run in subprocesses, started
together: a pytest worker may hold another process group already."""
import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.dist import meshes as jmeshes
from repro.models import model_zoo as jzoo
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist import meshes
from repro_torch.launch import dryrun
from repro_torch.models import model_zoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _start(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.Popen([sys.executable, *args], env=env, cwd=REPO, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-2000:] + err[-3000:]
    return out


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """The module's subprocesses, started together: the CLI on one cell,
    the extrapolation cells, and rwkv6-3b's train_4k on each mesh."""
    out_dir = tmp_path_factory.mktemp("dryrun")
    procs = {
        "cli": _start(["-m", "repro_torch.launch.dryrun", "--arch", "rwkv6-3b", "--shape",
                       "decode_32k", "--mesh", "multi", "--out", str(out_dir)]),
        "extrapolation": _start(["-c", _EXTRAPOLATION]),
        "single": _start(["-c", _TRAIN.format(multi=False)]),
        "multi": _start(["-c", _TRAIN.format(multi=True)]),
        "totals": _start(["-c", _TOTALS]),
    }
    got = {k: _finish(p) for k, p in procs.items()}
    got["cli"] = json.loads((out_dir / "rwkv6-3b__decode_32k__pod2x16x16.json").read_text())
    for k in ("extrapolation", "single", "multi", "totals"):
        got[k] = json.loads(got[k].strip().splitlines()[-1])
    return got


def test_dryrun_cell_subprocess(live):
    rec = live["cli"]
    assert rec["status"] == "ok"
    assert rec["n_devices"] == 512
    assert rec["cost"]["flops"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert "calibration" in rec and rec["calibration"]["real_counts"] == {"rwkv": 32}
    # the cache is updated in place; the wkv state splits its heads over the
    # model axis and is made whole for each layer
    assert 0 < rec["memory"]["alias_bytes"] < rec["memory"]["argument_bytes"]
    assert rec["collectives"]["by_kind"]["broadcast"]["count"] > 0


# ------------------------------ the counters ---------------------------------
def test_counters_on_a_two_op_chain():
    m, k, n = 64, 32, 48
    a = torch.empty(m, k, device="meta")
    b = torch.empty(k, n, device="meta")
    got = dryrun.measure(lambda a, b: torch.relu(a @ b), a, b)
    assert got["cost"]["flops"] == 2 * m * k * n
    mm = (m * k + k * n + m * n) * 4  # read a and b, write c
    relu = 2 * m * n * 4  # read c, write d
    assert got["cost"]["bytes_accessed"] == mm + relu
    assert got["memory"] == {"argument_bytes": (m * k + k * n) * 4,
                             "output_bytes": m * n * 4,
                             "temp_bytes": 2 * m * n * 4,  # c and d live together
                             "alias_bytes": 0}


def test_counters_see_in_place_writes_views_and_frees():
    a = torch.empty(100, device="meta")
    b = torch.empty(100, device="meta", dtype=torch.float64)

    def fn(a, b):
        for _ in range(3):  # each temporary freed before the next
            t = a * 2.0
            del t
        a[:50].add_(1.0)  # a view (no bytes), an in-place write of a
        return b

    got = dryrun.measure(fn, a, b)
    assert got["cost"]["flops"] == 0
    assert got["memory"]["temp_bytes"] == 400
    assert got["memory"]["alias_bytes"] == 400
    assert got["memory"]["output_bytes"] == 0
    assert got["cost"]["bytes_accessed"] == 3 * 800 + 2 * 200
    # a second run is answered from the memo: the same counts
    assert dryrun.measure(fn, a, b)["cost"] == got["cost"]


@pytest.mark.parametrize("arch", ["rwkv6-3b", "olmoe-1b-7b", "hymba-1.5b", "minicpm3-4b",
                                  "seamless-m4t-medium", "internvl2-26b"])
def test_flops_equal_flop_counter_mode(arch):
    """The meter's count on meta equals ``FlopCounterMode``'s total over the
    same train step run for real on the CPU (a reduced model)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_reduced_config
    from repro_torch.train.optimizer import OptConfig, adamw_init, make_train_step

    cfg = get_reduced_config(arch)
    counts = {}
    for device in ("cpu", "meta"):
        params, _ = model_zoo.init_params(cfg, seed=0, device=device, dtype=torch.float32)
        step = make_train_step(model_zoo.loss_fn(cfg, remat="full", wkv_impl="plain"),
                               OptConfig())
        opt = adamw_init(params, OptConfig())
        shape = model_zoo.ShapeSpec("tiny", 32 + cfg.vis_tokens, 2, "train")
        if device == "cpu":
            batch = model_zoo.demo_batch(cfg, 2, shape.seq_len, device="cpu")
            with FlopCounterMode(display=False) as fc:
                step(params, opt, batch)
            counts[device] = fc.get_total_flops()
        else:
            batch = model_zoo.input_specs(cfg, shape)
            counts[device] = dryrun.measure(step, params, opt, batch)["cost"]["flops"]
    assert counts["meta"] == counts["cpu"] > 0


def test_memo_tells_an_int_scalar_from_a_float_one():
    x = torch.empty(3, dtype=torch.int64, device="meta")
    with dryrun.StepMeter([]):
        a = torch.ops.aten.add.Scalar(x, 1)
        b = torch.ops.aten.add.Scalar(x, 1.0)
    assert (a.dtype, b.dtype) == (torch.int64, torch.float32)


def test_memo_gives_fresh_tensors_of_the_recorded_layout():
    x = torch.empty(4, 6, device="meta").t()
    meter = dryrun.StepMeter([])
    with meter:
        y1 = x * 2
        y2 = x * 2
    assert len(meter.memo) == 1
    assert y1.untyped_storage()._cdata != y2.untyped_storage()._cdata
    assert (y1.shape, y1.stride(), y1.dtype) == (y2.shape, y2.stride(), y2.dtype)


@pytest.mark.parametrize("seq", [256, 512])
def test_grouped_wkv_counts_as_the_per_chunk_form(seq):
    """The dry-run's WKV form (``WKV_IMPL``, ``wkv_chunked_grouped``) on a
    reduced rwkv6-3b train step on meta, against the per-chunk form
    (``wkv_chunked_ref``): the same arguments, aliases and outputs, flops
    within 1e-3 and temporaries within 10% (measured: 3e-4 and 7% at 256
    positions; 2e-5 and 2% at full size, ``tools/dryrun_wkv_forms.py``).
    Its bytes are fewer, by the per-chunk form's autograd, which writes a
    whole-size gradient for each chunk it selects: 0.76 of them at 256
    positions, 0.56 at full size."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.train.optimizer import OptConfig, adamw_init, make_train_step

    assert dryrun.WKV_IMPL == "grouped"
    cfg = get_reduced_config("rwkv6-3b")
    got = {}
    for form in ("plain", "grouped"):
        params, _ = model_zoo.init_params(cfg, device="meta", dtype=torch.float32)
        step = make_train_step(model_zoo.loss_fn(cfg, remat="full", wkv_impl=form),
                               OptConfig())
        batch = model_zoo.input_specs(cfg, model_zoo.ShapeSpec("t", seq, 2, "train"))
        got[form] = dryrun.measure(step, params, adamw_init(params, OptConfig()), batch)
    p, g = got["plain"], got["grouped"]
    for k in ("argument_bytes", "alias_bytes", "output_bytes"):
        assert g["memory"][k] == p["memory"][k], k
    assert g["cost"]["flops"] == pytest.approx(p["cost"]["flops"], rel=1e-3)
    assert g["memory"]["temp_bytes"] == pytest.approx(p["memory"]["temp_bytes"], rel=0.1)
    assert 0.5 * p["cost"]["bytes_accessed"] < g["cost"]["bytes_accessed"] \
        < p["cost"]["bytes_accessed"]


# ------------------------------ collective totals ----------------------------
TOTALS_CALLS = 20000

_TOTALS = textwrap.dedent(
    f"""
    import json, torch
    from repro_torch.dist import meshes
    from repro_torch.launch import dryrun
    from repro_torch.roofline.collectives import collective_stats

    dryrun.fake_group(256)
    mesh = meshes.make_production_mesh(device="cpu")
    meshes.reset_collectives()
    t, sizes, events = torch.empty(8, device="meta"), set(), []
    for i in range({TOTALS_CALLS}):
        n = 1 + i % 7
        meshes.all_reduce(t[:n], mesh, "model")
        meshes.broadcast(t[:n], 0)
        events += [("all-reduce", 4 * n, 16), ("broadcast", 4 * n, 256)]
        sizes.add(len(meshes.COLLECTIVE_TOTALS))
    print(json.dumps({{"sizes": sorted(sizes), "events": collective_stats(events),
                       "totals": collective_stats(meshes.COLLECTIVE_TOTALS)}}))
    """
)


def test_collective_totals_stay_bounded(live):
    """A long loop of collectives leaves the mesh layer's totals at one
    entry a kind and group size, and they price as the calls one by one."""
    got = live["totals"]
    assert got["sizes"] == [2]
    totals, events = got["totals"], got["events"]
    assert totals["total_result_bytes"] == events["total_result_bytes"]
    assert totals["total_wire_bytes"] == pytest.approx(events["total_wire_bytes"], rel=1e-12)
    for kind in ("all-reduce", "broadcast"):
        t, e = totals["by_kind"][kind], events["by_kind"][kind]
        assert t["count"] == e["count"] == TOTALS_CALLS
        assert t["result_bytes"] == e["result_bytes"]
        assert t["wire_bytes"] == pytest.approx(e["wire_bytes"], rel=1e-12)


# ------------------------ extrapolation and the ratio ------------------------
_EXTRAPOLATION = textwrap.dedent(
    """
    import dataclasses, json
    from repro.configs import get_config as jget_config
    from repro.launch import dryrun as jdryrun
    from repro_torch.configs import get_config
    from repro_torch.dist import meshes
    from repro_torch.launch import dryrun
    from repro_torch.models import model_zoo

    out = {}
    dryrun.fake_group(256)
    mesh = meshes.make_production_mesh(device="cpu")
    for arch, shape in (("rwkv6-3b", "decode_32k"), ("hymba-1.5b", "long_500k")):
        jcfg = jget_config(arch)
        real, variants = jdryrun.calibration_plan(jcfg)
        cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16")
        m = {}
        for label, counts in [("full", real)] + variants:
            jc = jdryrun.with_kind_counts(jcfg, counts)
            c = dataclasses.replace(cfg, n_layers=jc.n_layers,
                                    n_global_layers=jc.n_global_layers)
            r = dryrun._lower_and_measure(c, model_zoo.SHAPES[shape], mesh)
            m[label] = [r["cost"]["flops"], r["cost"]["bytes_accessed"],
                        r["collectives"]["total_wire_bytes"]]
        out[arch] = {"real": real, "m": m}
    print(json.dumps(out))
    """
)

_TRAIN = textwrap.dedent(
    """
    import json
    from repro_torch.launch import dryrun
    rec = dryrun.lower_cell("rwkv6-3b", "train_4k", {multi})
    print(json.dumps({{"n": rec["n_devices"], "flops": rec["cost"]["flops"]}}))
    """
)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b"])
def test_full_depth_equals_the_reference_extrapolation(live, arch):
    """The reference extrapolates from 1- and 2-layer lowerings
    (``dryrun.py:186-194``); the port runs every layer, and its count is that
    formula applied to its own 1- and 2-layer counts."""
    real, m = live["extrapolation"][arch]["real"], live["extrapolation"][arch]["m"]
    assert len(real) == (2 if arch == "hymba-1.5b" else 1)
    for i in range(3):
        base = m["base"][i]
        total = base
        for kind, n in real.items():
            if kind in m:
                total += (n - 1) * (m[kind][i] - base)
            elif n > 1:
                total += (n - 1) * base
        assert m["full"][i] == pytest.approx(total, rel=1e-12, abs=1e-3), (arch, i)
    assert m["full"][0] > m["base"][0] > 0


def test_multi_pod_halves_rwkv_train_flops_a_device(live):
    """The reference's check on its artifacts (``test_dryrun_integration``),
    here run live: per-device numbers drop from 256 to 512 ranks."""
    single, multi = live["single"], live["multi"]
    assert multi["n"] == 2 * single["n"] == 512
    ratio = multi["flops"] / single["flops"]
    assert 0.4 < ratio < 0.75, ratio


# ------------------------------ fallbacks ------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_fallbacks_equal_reference(arch):
    """The drops the resolver records for each architecture's full-width
    parameters on the (16 x 16) mesh, with nothing lowered or run."""
    params, specs = model_zoo.init_params(get_config(arch), device="meta")
    with meshes.use_mesh(meshes.AbstractMesh((16, 16), ("data", "model"))) as mesh:
        meshes.tree_shardings(specs, params, mesh)
        got = meshes.fallbacks()
    jparams, jspecs = jzoo.init_params(jget_config(arch), abstract=True)
    with jmeshes.use_mesh(jax.sharding.AbstractMesh((16, 16), ("data", "model"))) as jmesh:
        jmeshes.tree_shardings(jspecs, jparams, jmesh)
        want = jmeshes.fallbacks()
    assert got == want
