"""The port's serving launcher (``repro_torch.launch.serve``) and the serving
helpers of ``launch/common.py`` on the CPU (``--device cpu --reduced``): dense
and paged, the kernel path's plain version, the scheduler and fault flags,
trace replay, and ``launch/score.py``'s narrower scheduler choice."""
import argparse

import pytest

from test_torch_serve_util import one_cpu_thread  # noqa: F401
from repro_torch.dist import meshes
from repro_torch.launch import common
from repro_torch.launch import serve as serve_cli

BASE = ["--arch", "internlm2-20b", "--reduced", "--device", "cpu", "--batch", "2",
        "--requests", "3", "--prompt-len", "6", "--max-new", "3"]


def test_dense_smoke_records_the_kernel_fallback(capsys):
    meshes.clear_fallbacks()
    done = serve_cli.main(BASE)  # --attn-impl kernel by default: dense serves gather
    assert len(done) == 3 and all(len(r.out) == 3 for r in done)
    msg = capsys.readouterr().out
    assert "[serve] internlm2-20b on cpu" in msg and "tok/s" in msg and "occupancy" in msg
    assert any(t == "serve_attn" for t, _, _ in meshes.fallbacks())


@pytest.mark.parametrize("impl", ["kernel", "gather"])
def test_paged_chunked_smoke(capsys, impl):
    done = serve_cli.main(BASE + ["--kv", "paged", "--block-size", "4", "--prefill-chunk", "3",
                                  "--attn-impl", impl])
    assert len(done) == 3 and all(len(r.out) == 3 for r in done)
    msg = capsys.readouterr().out
    assert "kv=paged" in msg and "blocks" in msg and f"attn={impl}" in msg


@pytest.mark.parametrize("impl", ["kernel", "gather"])
def test_mla_arch_serves_paged_tokens(capsys, impl):
    """minicpm3-4b (MLA): the absorbed-latent decode, on the kernel path
    through B5's plain version."""
    argv = ["--arch", "minicpm3-4b"] + BASE[2:] + ["--kv", "paged", "--block-size", "4",
                                                   "--prefill-chunk", "3", "--attn-impl", impl]
    done = serve_cli.main(argv)
    assert len(done) == 3 and all(len(r.out) == 3 for r in done)
    msg = capsys.readouterr().out
    assert "[serve] minicpm3-4b on cpu" in msg and f"attn={impl}" in msg


def test_paged_outputs_match_dense(capsys):
    dense = [r.out for r in serve_cli.main(BASE)]
    paged = [r.out for r in serve_cli.main(BASE + ["--kv", "paged", "--block-size", "4"])]
    assert dense == paged


def test_scheduler_fault_and_bench_out_flags(capsys, tmp_path):
    out = tmp_path / "serve.json"
    done = serve_cli.main(["--arch", "mistral-nemo-12b", "--reduced", "--device", "cpu",
                           "--batch", "4", "--requests", "12", "--kv", "paged",
                           "--prefill-chunk", "4", "--high-frac", "0.25", "--fault-seed", "3",
                           "--bench-out", str(out)])
    assert len(done) == 12
    msg = capsys.readouterr().out
    assert "[sched] scheduler=priority" in msg and "faults_applied=" in msg
    assert '"serving"' in out.read_text()


def test_trace_replay_with_wdrr(capsys):
    done = serve_cli.main(["--arch", "internlm2-20b", "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8", "--max-new", "4", "--kv",
                           "paged", "--block-size", "4", "--prefill-chunk", "4",
                           "--scheduler", "wdrr", "--tenant-weights", "0=1,1=3",
                           "--trace-seed", "7", "--trace-steps", "8"])
    assert len(done) > 0
    msg = capsys.readouterr().out
    assert "[trace]" in msg and "[prefix]" in msg and "tokens by tenant" in msg


def test_common_helpers():
    assert common.parse_tenant_weights(None) is None
    assert common.parse_tenant_weights("0=1,1=2,interactive=4") == {
        0: 1.0, 1: 2.0, "interactive": 4.0}
    with pytest.raises(SystemExit, match="bad entry"):
        common.parse_tenant_weights("0=1,oops")
    ap = argparse.ArgumentParser()
    common.add_kv_flags(ap)
    args = ap.parse_args(["--prefix-cache", "off"])
    assert (args.kv, args.block_size, args.kv_blocks) == ("dense", 16, None)
    assert [common.prefix_cache_from_args(ap.parse_args(["--prefix-cache", v]))
            for v in ("auto", "on", "off")] == [None, True, False]
    score = argparse.ArgumentParser()
    common.add_scheduler_flags(score)  # the score launcher: no wdrr, no fault knobs
    with pytest.raises(SystemExit):
        score.parse_args(["--scheduler", "wdrr"])
    assert not hasattr(score.parse_args([]), "fault_seed")
    serve = argparse.ArgumentParser()
    common.add_scheduler_flags(serve, serving=True)
    a = serve.parse_args(["--scheduler", "wdrr", "--fault-seed", "2"])
    assert (a.scheduler, a.fault_seed, a.fault_horizon, a.high_frac) == ("wdrr", 2, 24, 0.0)
