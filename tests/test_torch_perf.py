"""The port's perf experiments (``repro_torch.launch.perf``) against
``repro.launch.perf``: the same labels with the same cells and arguments,
and one experiment run into a temporary directory. The reference module
sets ``XLA_FLAGS`` when imported, so its table is read from its source."""
import ast
import json
import os
import subprocess
import sys

from repro_torch.launch import perf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_experiments() -> dict:
    path = os.path.join(REPO, "src", "repro", "launch", "perf.py")
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and [getattr(t, "id", None)
                                             for t in node.targets] == ["EXPERIMENTS"]:
            return ast.literal_eval(node.value)
    raise AssertionError("no EXPERIMENTS in the reference")


def test_experiments_equal_reference():
    want = _reference_experiments()
    assert list(perf.EXPERIMENTS) == list(want)
    assert perf.EXPERIMENTS == want
    assert perf.PERF_DIR == os.path.join("artifacts", "torch", "perf")


def test_run_one_writes_its_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.perf", "--label", "A0_baseline",
         "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert out.stdout.startswith("[A0_baseline] compute=")
    rec = json.loads((tmp_path / "A0_baseline.json").read_text())
    assert rec["label"] == "A0_baseline" and rec["status"] == "ok"
    assert (rec["arch"], rec["shape"], rec["mesh"]) == ("minicpm3-4b", "prefill_32k",
                                                        "pod16x16")
    assert rec["cost"]["flops"] > 0 and rec["n_devices"] == 256
