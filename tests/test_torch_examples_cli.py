"""The command lines of ``repro_torch.launch.quickstart``, ``serve_lm``,
``train_lm`` and ``dana_vs_madlib`` (the ports of ``examples/quickstart.py``,
``serve_lm.py``, ``train_lm.py`` and ``dana_vs_madlib.py``): with ``--device
cpu``, in a subprocess, each prints the example's lines and ``OK`` (serve_lm
at the example's own settings, sampling at 0.7: 8 x 48 tokens for each of
the three archs; dana_vs_madlib with its heap in a temporary directory);
without it,
on a box with no card, each raises ``RuntimeError`` before it builds
anything, as ``test_torch_system.test_entry_points_raise_without_a_card``
holds the other entry points."""
import importlib
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ("quickstart", "serve_lm", "train_lm", "dana_vs_madlib")
ARGV = {"quickstart": [], "serve_lm": [], "train_lm": ["--small", "--steps", "8"],
        "dana_vs_madlib": []}


@pytest.mark.parametrize("name", MODULES)
def test_command_line_on_the_cpu_prints_ok(name):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{name}", "--device", "cpu", *ARGV[name]],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == "OK"
    if name == "serve_lm":
        served = [ln for ln in lines if "tok/s (batch 8)" in ln]
        assert [ln.split()[0] for ln in served] == ["internlm2-20b", "minicpm3-4b", "rwkv6-3b"]
        assert all(re.search(r"\]: 384 tokens / ", ln) for ln in served), served
    if name == "quickstart":
        assert "scored 2403/5000 rows (2597 filtered), schema ('c0', 'prediction')" in lines
    if name == "train_lm":
        assert any(ln.startswith("-- simulated preemption at step 4 --") for ln in lines)
    if name == "dana_vs_madlib":
        assert lines[0] == ("workload remote_sensing_lr: 5811 tuples x 54 features "
                            "(43 pages) [scaled from 581,102]")
        assert lines[5].startswith("FPGA cycle model @ full size (581,102 tuples): ")


@pytest.mark.parametrize("name", MODULES)
def test_main_raises_without_a_card(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"repro_torch.launch.{name}")
    argv = ARGV[name] + (["--workdir", str(tmp_path)] if name != "serve_lm" else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
    assert os.listdir(tmp_path) == []
