"""The training and serving launchers under torchrun's variables, on CPU
ranks. Training: two
processes of ``python -m repro_torch.launch.train`` with ``WORLD_SIZE``,
``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set join one gloo group and
train reduced rwkv6-3b from token pages on the host mesh, (2 x 1) or, with
``--model-parallel 2``, (1 x 2). Rank 0 alone prints the summary and writes
``--bench-out`` and the checkpoint (each rank keeps its own token heap), the
checkpoint's manifest is a lone process's, and so is the loss, at the bound
of bf16 activations. Serving: two processes of ``python -m
repro_torch.launch.serve --mesh host --model-parallel 2`` serve reduced
internlm2-20b with its KV heads over the model axis, and rank 0's summary
is a lone unsharded run's with the mesh and the path after it."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from test_torch_dist_util import REPO
from test_torch_rwkv import BF16_LOSS
from test_torch_serve_util import one_cpu_thread  # noqa: F401

ARGS = ["--arch", "rwkv6-3b", "--reduced", "--device", "cpu", "--steps", "3", "--batch", "4",
        "--seq", "16", "--ckpt-every", "3", "--data-path", "pages"]
RANK_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks(argv, world, module="repro_torch.launch.train"):
    """``world`` processes of the launcher ``module`` with torchrun's
    variables; their output."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo", WORLD_SIZE=str(world), MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-m", module, *argv],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    return outs


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_launcher_trains_on_torchrun_ranks(tmp_path, one_cpu_thread, model_parallel):  # noqa: F811
    from repro_torch.launch import train as train_cli

    lone = train_cli.main(ARGS + ["--ckpt-dir", str(tmp_path / "lone")])
    ck, bench = tmp_path / "ranks", tmp_path / "bench.json"
    outs = _ranks(ARGS + ["--ckpt-dir", str(ck), "--bench-out", str(bench),
                          "--model-parallel", str(model_parallel)], 2)
    assert "[train] loss" in outs[0] and "[bench] wrote" in outs[0]
    assert "[train]" not in outs[1] and "[bench]" not in outs[1]
    with open(bench) as f:
        got = json.load(f)
    assert got["steps"] == len(lone) == 1  # step 1 of 3 at log_every 10
    np.testing.assert_allclose(got["loss_first"], lone[0]["loss"], rtol=BF16_LOSS)
    assert sorted(os.listdir(ck)) == ["step_00000003", "tokens.1.heap", "tokens.1.heap.meta",
                                      "tokens.heap", "tokens.heap.meta"]
    manifests = []
    for d in (ck, tmp_path / "lone"):
        with open(d / "step_00000003" / "manifest.json") as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]


SERVE_ARGS = ["--arch", "internlm2-20b", "--reduced", "--device", "cpu", "--batch", "4",
              "--requests", "6", "--prompt-len", "6", "--max-new", "5", "--kv", "paged",
              "--block-size", "4", "--prefill-chunk", "2"]


def test_serve_launcher_on_torchrun_ranks(tmp_path, capsys, one_cpu_thread):  # noqa: F811
    """``launch/serve.py --mesh host --model-parallel 2`` as 2 processes with
    torchrun's variables: (1 x 2), the KV heads over the model axis through
    B5's plain version. Rank 0 alone prints and writes ``--bench-out``; its
    summary is a lone unsharded run's (the same requests, tokens and
    counters) with ``mesh=... path=...`` after it."""
    from repro_torch.launch import serve as serve_cli

    lone_bench, bench = tmp_path / "lone.json", tmp_path / "bench.json"
    serve_cli.main(SERVE_ARGS + ["--bench-out", str(lone_bench)])
    lone = capsys.readouterr().out.splitlines()
    outs = _ranks(SERVE_ARGS + ["--mesh", "host", "--model-parallel", "2", "--bench-out",
                                str(bench)], 2, "repro_torch.launch.serve")
    assert "[serve]" not in outs[1] and "[bench]" not in outs[1]
    lines = outs[0].splitlines()
    summary = [ln for ln in lines if ln.startswith("[serve]")]
    assert len(summary) == 1
    assert summary[0].endswith(" mesh={'data': 1, 'model': 2} path=('gspmd', (), 'model')")
    lone_summary = next(ln for ln in lone if ln.startswith("[serve]"))
    # the same head (requests, tokens) and tail (TTFT steps, blocks, path)
    # as the lone run's, up to the times
    assert summary[0].split(" tokens in ")[0] == lone_summary.split(" tokens in ")[0]
    assert summary[0].split(" kv=paged ")[1].startswith(lone_summary.split(" kv=paged ")[1])
    assert [ln for ln in lines if ln.startswith("  req ")] == \
        [ln for ln in lone if ln.startswith("  req ")]
    with open(bench) as f, open(lone_bench) as g:
        got, want = json.load(f)["serving"], json.load(g)["serving"]
    for key in ("steps", "admitted", "finished", "tokens_generated", "prompt_tokens",
                "kv_blocks_peak", "kv_bytes_written"):
        assert got[key] == want[key], key
