"""The port's copies of the Strider ISA, its compiler and the hardware
generator (repro_torch.core.{isa,striders,scheduler,hwgen}) against repro's:
assembled programs, interpreter FIFOs, cycle models and design points equal,
with and without a projection plan. Also the ISA-interpreter parity of the
port's plain page decodes, full and projected: the interpreter's FIFO is the
bit-level ground truth."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.algorithms as jalgos
from repro.core import hwgen as jhwgen
from repro.core import isa as jisa
from repro.core import scheduler as jscheduler
from repro.core import striders as jstriders
from repro.core import translator as jtranslator
from repro.db.page import PageLayout as JPageLayout
from repro_torch import algorithms
from repro_torch.core import hwgen, isa, scheduler, striders
from repro_torch.core.translator import trace
from repro_torch.db.heap import write_token_table
from repro_torch.db.page import PageLayout, build_pages
from repro_torch.kernels.strider import ops

LAYOUTS = [(5, 512, False), (11, 1024, False), (11, 1024, True), (54, 8192, True),
           (40, 4096, False)]
PLANS = {"none": None, "full": "full", "first": [0], "scattered": [0, 3, 4, 9],
         "tail": [-1], "label_only": []}


def _layouts(d, page_bytes, quant):
    return (PageLayout(n_features=d, page_bytes=page_bytes, quantized=quant),
            JPageLayout(n_features=d, page_bytes=page_bytes, quantized=quant))


def _plan(mod, layout, spec, include_label=True):
    """The plan ``spec`` names (column list, negative from the end) on
    ``layout``; a plan with no columns keeps the label."""
    if spec is None:
        return None
    if spec == "full":
        return mod.full_plan(layout)
    d = layout.n_features
    cols = [c for c in (c if c >= 0 else d + c for c in spec) if c < d]
    return mod.projection_plan(layout, cols, include_label=include_label or not cols)


def _same_error(fn, jfn):
    with pytest.raises(ValueError) as e:
        fn()
    with pytest.raises(ValueError) as je:
        jfn()
    assert str(e.value) == str(je.value)


def _pages(layout, n, seed):
    rng = np.random.default_rng(seed)
    return build_pages(rng.normal(0, 2, (n, layout.n_features)).astype(np.float32),
                       rng.normal(0, 2, n).astype(np.float32), layout)


@pytest.mark.parametrize("label", [True, False])
@pytest.mark.parametrize("spec", list(PLANS))
@pytest.mark.parametrize("geom", LAYOUTS)
def test_programs_and_cycle_models_equal(geom, spec, label):
    lo, jlo = _layouts(*geom)
    plan, jplan = _plan(striders, lo, PLANS[spec], label), _plan(jstriders, jlo, PLANS[spec], label)
    np.testing.assert_array_equal(striders.compile_strider_program(lo, plan),
                                  jstriders.compile_strider_program(jlo, jplan))
    assert (striders.strider_cycles_per_page(lo, plan)
            == jstriders.strider_cycles_per_page(jlo, jplan))
    if plan is not None:
        assert (plan.columns, plan.words, plan.runs, plan.include_label) == (
            jplan.columns, jplan.words, jplan.runs, jplan.include_label)
        assert (plan.bytes_per_tuple, plan.bytes_per_tuple_full) == (
            jplan.bytes_per_tuple, jplan.bytes_per_tuple_full)
        assert plan.column_positions() == jplan.column_positions()
        if lo.quantized:
            assert plan.column_byte_positions() == jplan.column_byte_positions()


@pytest.mark.parametrize("spec", list(PLANS))
@pytest.mark.parametrize("geom", LAYOUTS[:4])
def test_run_strider_fifo_equal(geom, spec):
    lo, jlo = _layouts(*geom)
    plan, jplan = _plan(striders, lo, PLANS[spec]), _plan(jstriders, jlo, PLANS[spec])
    pages = _pages(lo, lo.tuples_per_page + 3, seed=geom[0])
    prog = striders.compile_strider_program(lo, plan)
    if spec == "label_only" and not lo.quantized:
        # both run_strider post-stages index with an empty float array here
        for fn, args in ((striders.run_strider, (lo, plan)), (jstriders.run_strider, (jlo, jplan))):
            with pytest.raises(IndexError):
                fn(prog, pages[0], *args)
        return
    for page in pages:
        f, l, c = striders.run_strider(prog, page, lo, plan)
        jf, jl, jc = jstriders.run_strider(prog, page, jlo, jplan)
        np.testing.assert_array_equal(f.view(np.int32), jf.view(np.int32))
        np.testing.assert_array_equal(l.view(np.int32), jl.view(np.int32))
        assert c == jc
        raw = np.asarray(page, np.uint32).view(np.uint8)
        assert (isa.StriderInterpreter(prog).run(raw).fifo
                == jisa.StriderInterpreter(prog).run(raw).fifo)


def test_assembler_and_encoding_equal():
    prog = [("readB", 16, 4, "%cr0"), ("ins", "%t3", 17, 25), ("bentr",),
            ("writeB", "%t3", "%cr7", 0), ("bexit", 0, "%t2", "%cr0")]
    prog += isa.load_imm("%cr9", 123_456_789)
    np.testing.assert_array_equal(isa.assemble(prog), jisa.assemble(prog))
    for word in isa.assemble(prog):
        assert isa.decode(int(word)) == jisa.decode(int(word))
    for bad in (("readB", 40, 4, "%cr0"), ("ad", "%x1", 0, 0)):
        _same_error(lambda: isa.encode(*bad), lambda: jisa.encode(*bad))


@pytest.mark.parametrize("spec", ["none", "full", "scattered", "label_only"])
@pytest.mark.parametrize("quant", [False, True])
def test_plain_decodes_match_isa_fifo(quant, spec):
    """The port's plain decodes against the ISA interpreter, page by page."""
    lo = PageLayout(n_features=11, page_bytes=1024, quantized=quant)
    plan = _plan(striders, lo, PLANS[spec])
    pages = _pages(lo, 2 * lo.tuples_per_page + 5, seed=3)
    prog = striders.compile_strider_program(lo, plan)
    pt = ops.pages_tensor(pages)
    if plan is None:
        f, l, m = ops.decode_pages(pt, lo)
    else:
        f, l, m = ops.decode_pages_projected(pt, lo, plan)
    for i, page in enumerate(pages):
        if plan is not None and not plan.columns:
            # label only: the FIFO is the labels' bytes (run_strider's
            # post-stage cannot take this plan on f32 pages)
            fifo = isa.StriderInterpreter(prog).run(np.asarray(page, np.uint32).view(np.uint8))
            gy = np.asarray(fifo.fifo, np.uint8).view(np.float32)
            gx = np.zeros((gy.size, 0), np.float32)
        else:
            gx, gy, _ = striders.run_strider(prog, page, lo, plan)
        k = gx.shape[0]
        np.testing.assert_array_equal(f[i, :k].numpy(), gx)
        np.testing.assert_array_equal(l[i, :k].numpy(), gy)
        assert not f[i, k:].any() and int(m[i].sum()) == k


def test_full_plan_decode_keeps_denormal_tokens(tmp_path):
    seqs = [[1, 2, 3, 4], [7, 0, 5], [2**31 - 1, 1, 2**20], [9]]
    heap = write_token_table(str(tmp_path / "tok.heap"), seqs, page_bytes=8192)
    pt = ops.pages_tensor(heap.read_all())
    got = ops.decode_pages_projected(pt, heap.layout, striders.full_plan(heap.layout))
    for g, w in zip(got, ops.decode_pages(pt, heap.layout)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    for i, s in enumerate(seqs):
        assert got[0][0, i, : len(s)].view(torch.int32).tolist() == s


def test_projection_plan_rejections_match():
    lo, jlo = _layouts(11, 1024, False)
    for cols, label in (([], False), ([11], True), ([-1], True)):
        _same_error(lambda: striders.projection_plan(lo, cols, label),
                    lambda: jstriders.projection_plan(jlo, cols, label))


# ------------------------------ scheduler, hwgen -----------------------------
ALGOS = [("linear_regression", (54,), dict(merge_coef=64)),
         ("logistic_regression", (54,), dict(merge_coef=256)),
         ("svm", (16,), dict(merge_coef=8)),
         ("lrmf", (64,), dict(rank=8, merge_coef=4))]


def _graphs(name, args, kw):
    g, part = trace(lambda: getattr(algorithms, name)(*args, **kw))
    jg, jpart = jtranslator.trace(lambda: getattr(jalgos, name)(*args, **kw))
    return (g, part), (jg, jpart)


@pytest.mark.parametrize("n_acs", [1, 2, 8])
@pytest.mark.parametrize("algo", ALGOS, ids=[a[0] for a in ALGOS])
def test_schedules_equal(algo, n_acs):
    (g, part), (jg, jpart) = _graphs(*algo)
    for phase in ("pre_merge", "post_merge", "convergence"):
        got = scheduler.schedule(g, getattr(part, phase), n_acs)
        want = jscheduler.schedule(jg, getattr(jpart, phase), n_acs)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (scheduler.merge_tree_cycles(64, 16, n_acs)
            == jscheduler.merge_tree_cycles(64, 16, n_acs))


@pytest.mark.parametrize("n_tuples", [138, 581_102])
@pytest.mark.parametrize("algo", ALGOS, ids=[a[0] for a in ALGOS])
def test_design_points_equal(algo, n_tuples):
    (g, part), (jg, jpart) = _graphs(*algo)
    d = algo[1][0]
    lo, jlo = _layouts(d, 32 * 1024, False)
    point = hwgen.explore(g, part, lo, n_tuples=n_tuples)
    jpoint = jhwgen.explore(jg, jpart, jlo, n_tuples=n_tuples)
    assert dataclasses.asdict(point) == dataclasses.asdict(jpoint)
    assert point.total_aus == jpoint.total_aus
    for kw in (dict(), dict(bandwidth_scale=0.5), dict(warm_cache=False)):
        assert (hwgen.modeled_runtime_s(point, lo, n_tuples, epochs=3, **kw)
                == jhwgen.modeled_runtime_s(jpoint, jlo, n_tuples, epochs=3, **kw))
