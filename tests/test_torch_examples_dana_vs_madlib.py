"""``repro_torch.launch.workloads`` and ``repro_torch.launch.dana_vs_madlib``
(the ports of ``benchmarks/workloads.py`` and ``examples/dana_vs_madlib.py``)
against ``repro``'s own harness and example on the CPU, each side with heap
files in a temporary directory of its own: the heap byte for byte; each
mode's coefficients within ``test_torch_system.TOL`` of ``repro``'s
``time_mode``, with its epochs and joins equal; the FPGA model equal for
every workload, for a given thread count and where the design does not
fit; the engine and the warm-up made once; the example's lines.

The MADlib analogue batches the tuples of each page (``coef`` at most a
page's tuples), where the engine batches the tuple stream, so its
coefficients come within TOL of the engine's only with merge batches on
page boundaries: ``chip_smoke.py`` holds it to that run on the card, and
``test_madlib_is_the_engine_with_merge_batches_on_pages`` holds the premise
in both packages."""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import solver
from repro_torch.core.engine import make_engine
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.launch import dana_vs_madlib, workloads
from test_torch_system import TOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # the reference's benchmarks package
    sys.path.insert(0, REPO)

from benchmarks import workloads as jworkloads  # noqa: E402

W = WORKLOADS[dana_vs_madlib.WORKLOAD]
SCALE = dana_vs_madlib.SCALE


@pytest.fixture(scope="module")
def heaps(tmp_path_factory):
    """The example's heap, written by each package into its own directory."""
    port_dir, ref_dir = tmp_path_factory.mktemp("port"), tmp_path_factory.mktemp("repro")
    mp = pytest.MonkeyPatch()
    mp.setattr(jworkloads, "BENCH_DIR", str(ref_dir))
    try:
        jheap = jworkloads.build_heap(jworkloads.WORKLOADS[W.name], SCALE)
    finally:
        mp.undo()
    return workloads.build_heap(W, SCALE, directory=str(port_dir)), jheap


def test_build_heap_writes_repros_bytes(heaps):
    heap, jheap = heaps
    assert os.path.basename(heap.path) == os.path.basename(jheap.path) == \
        "remote_sensing_lr_0.01.heap"
    for suffix in ("", ".meta"):  # the pages and the layout beside them
        with open(heap.path + suffix, "rb") as a, open(jheap.path + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    assert (heap.n_tuples, heap.n_pages) == (5811, 43)
    # a second call opens the file it wrote
    again = workloads.build_heap(W, SCALE, directory=os.path.dirname(heap.path))
    assert again.path == heap.path and again.n_pages == heap.n_pages


@pytest.mark.parametrize("mode", dana_vs_madlib.MODES)
def test_time_mode_matches_repros(heaps, mode):
    heap, jheap = heaps
    seconds, res = workloads.time_mode(W, heap, mode, epochs=1, device="cpu")
    _, want = jworkloads.time_mode(jworkloads.WORKLOADS[W.name], jheap, mode, epochs=1)
    assert seconds > 0
    assert (res.epochs_run, res.device_syncs) == (want.epochs_run, want.device_syncs)
    assert len(res.models) == len(want.models) == 1
    assert isinstance(res.models[0], np.ndarray)
    np.testing.assert_allclose(res.models[0], np.asarray(want.models[0]), **TOL)


def _point(point):
    return None if point is None else dataclasses.asdict(point)


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_fpga_model_equals_repros(name):
    point, rt = workloads.fpga_model(WORKLOADS[name])
    jpoint, jrt = jworkloads.fpga_model(jworkloads.WORKLOADS[name])
    assert _point(point) == _point(jpoint)
    assert point.total_aus == jpoint.total_aus
    assert rt == jrt


@pytest.mark.parametrize("name,kw", [
    ("remote_sensing_lr", dict(n_threads=1)),
    ("remote_sensing_lr", dict(n_threads=32, epochs=3, bandwidth_scale=0.5, warm=False)),
    ("netflix", dict(n_threads=8)),
    ("se_lrmf", dict(n_threads=64)),  # 1.1 MB of factors a thread: past the BRAM
    ("remote_sensing_lr", dict(n_threads=1 << 18)),  # 436 bytes a thread, 2^18 threads
])
def test_fpga_model_with_threads_equals_repros(name, kw):
    point, rt = workloads.fpga_model(WORKLOADS[name], **kw)
    jpoint, jrt = jworkloads.fpga_model(jworkloads.WORKLOADS[name], **kw)
    assert _point(point) == _point(jpoint)
    assert rt == jrt
    if kw["n_threads"] >= 64:
        assert (point, rt) == (None, None)
    else:
        assert point.n_threads == kw["n_threads"]


def test_a_second_call_makes_no_engine_and_no_warm_up(heaps, monkeypatch):
    heap, _ = heaps
    monkeypatch.setattr(workloads, "_CACHE", {})
    made, runs = [], []
    real_make, real_train = workloads.make_engine, solver.train

    def make(*args, **kw):
        made.append(kw.get("device"))
        return real_make(*args, **kw)

    def train(*args, **kw):
        runs.append(kw["max_epochs"])
        return real_train(*args, **kw)

    monkeypatch.setattr(workloads, "make_engine", make)
    monkeypatch.setattr(solver, "train", train)
    for mode in ("dana", "dana", "dana-nostrider", "dana-nostrider"):
        workloads.time_mode(W, heap, mode, epochs=1, device="cpu")
    # one engine for both modes; each mode's warm-up once, then its timed run
    assert made == [torch.device("cpu")]
    assert runs == [1, 1, 1, 1, 1, 1]
    assert sorted(map(str, workloads._CACHE)) == sorted(map(str, [
        (W.name, heap.n_tuples, torch.device("cpu")),
        (W.name, "dana", heap.n_tuples, True, torch.device("cpu")),
        (W.name, "dana-nostrider", heap.n_tuples, True, torch.device("cpu"))]))
    # another epoch count reuses them too
    workloads.time_mode(W, heap, "dana", epochs=2, device="cpu")
    assert len(made) == 1 and runs[-1] == 2 and len(runs) == 7


def test_time_mode_needs_a_card_for_the_device_modes_only(heaps, monkeypatch):
    heap, _ = heaps
    monkeypatch.setattr(workloads, "_CACHE", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("dana", "dana-nostrider"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            workloads.time_mode(W, heap, mode)
    assert workloads._CACHE == {}
    # the MADlib analogue is the CPU baseline whatever the device
    _, res = workloads.time_mode(W, heap, "madlib", device="cuda")
    assert res.epochs_run == 1 and res.models[0].shape == (W.n_features,)


def test_build_heap_honours_bench_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(workloads, "BENCH_DIR", str(tmp_path / "bench"))
    heap = workloads.build_heap(WORKLOADS["wlan"], 0.01)
    assert heap.path == os.path.join(str(tmp_path / "bench"), "wlan_0.01.heap")
    assert heap.n_tuples == 199


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_madlib_is_the_engine_with_merge_batches_on_pages(heaps, package):
    """The MADlib analogue's coefficients are the engine's when its merge
    batches are a page's tuples (the graph's divisor stays 256)."""
    heap, jheap = heaps
    if package == "repro":
        from repro.core import engine as jengine
        from repro.core import solver as jsolver

        g, part = jworkloads.traced(jworkloads.WORKLOADS[W.name])
        eng = jengine.make_engine(g, part, merge_coef=jheap.layout.tuples_per_page)
        got = jsolver.train(g, part, jheap, mode="dana", engine=eng, max_epochs=1).models[0]
        want = jsolver.madlib_train(g, part, jheap, max_epochs=1).models[0]
    else:
        g, part = workloads.traced(W)
        eng = make_engine(g, part, merge_coef=heap.layout.tuples_per_page, device="cpu")
        got = solver.train(g, part, heap, mode="dana", engine=eng, max_epochs=1,
                           device="cpu").models[0]
        want = solver.madlib_train(g, part, heap, max_epochs=1).models[0]
    np.testing.assert_allclose(np.asarray(want), np.asarray(got), **TOL)


_FIRST_RUN_SCRIPT = """
import sys
import numpy as np
from repro_torch.algorithms import logistic_regression
from repro_torch.core import solver
from repro_torch.core.translator import trace
from repro_torch.db.heap import write_table
rng = np.random.default_rng(0)
heap = write_table(sys.argv[1], rng.normal(size=(300, 54)).astype(np.float32),
                   (rng.random(300) > 0.5).astype(np.float32))
g, part = trace(lambda: logistic_regression(54, lr=0.1, merge_coef=256, epochs=1))
solver.madlib_train(g, part, heap, max_epochs=1)
assert "sympy" not in sys.modules, "the first run imported sympy"
print("FIRST RUN OK")
"""


def test_madlibs_first_run_imports_nothing_more(tmp_path):
    """The example times the MADlib analogue's first run in a process: the
    DSL's broadcast must not reach torch.broadcast_shapes, whose first call
    imports sympy (seconds)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", _FIRST_RUN_SCRIPT, str(tmp_path / "t.heap")],
                          env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "FIRST RUN OK" in proc.stdout


def _repro_example():
    spec = importlib.util.spec_from_file_location(
        "repro_example_dana_vs_madlib", os.path.join(REPO, "examples", "dana_vs_madlib.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_flow_prints_the_examples_lines(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(jworkloads, "BENCH_DIR", str(tmp_path / "repro"))
    _repro_example().main()
    want = capsys.readouterr().out.splitlines()
    args = dana_vs_madlib.build_parser().parse_args(
        ["--device", "cpu", "--workdir", str(tmp_path / "port")])
    out = dana_vs_madlib.flow(args)
    got = capsys.readouterr().out.splitlines()
    assert got == out["lines"]
    assert len(got) == len(want) == 7
    assert got[0] == want[0] == ("workload remote_sensing_lr: 5811 tuples x 54 features "
                                 "(43 pages) [scaled from 581,102]")
    # the three timings: the same labels, the times and ratios the run's own
    for g, w in zip(got[1:4], want[1:4]):
        assert g.split(":")[0] == w.split(":")[0]
    assert got[4] == want[4] == ""
    assert got[5] == want[5]
    assert "(128 threads, bandwidth-bound)" in got[5]
    assert got[6] == want[6] == "OK"
    assert sorted(os.listdir(tmp_path / "port")) == ["remote_sensing_lr_0.01.heap",
                                                     "remote_sensing_lr_0.01.heap.meta"]
    # the dict: the seconds and ratios it printed, each mode's result
    assert list(out["seconds"]) == list(dana_vs_madlib.MODES)
    for mode in ("dana-nostrider", "dana"):
        assert out["ratios"][mode] == out["seconds"]["madlib"] / out["seconds"][mode]
    assert {m: r["epochs_run"] for m, r in out["results"].items()} == \
        {"madlib": 1, "dana-nostrider": 1, "dana": 1}
    assert out["results"]["dana"]["device_syncs"] == 1
    np.testing.assert_allclose(out["results"]["dana-nostrider"]["models"][0],
                               out["results"]["dana"]["models"][0], rtol=1e-5, atol=1e-6)
    assert out["fpga_point"]["n_threads"] == 128 and out["fpga_rt"]["bound"] == "bandwidth"
