"""The port's training launcher (``repro_torch.launch.train``) on the CPU:
both data paths end to end at the reduced size, the device policy (the card
by default, so without one it raises), resuming from its checkpoint
directory, and the reference's ``--microbatch`` quirk."""
import inspect
import signal

import pytest
import torch

from repro_torch.launch import train as train_cli
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_loop
from test_torch_serve_util import one_cpu_thread  # noqa: F401

ARGS = ["--arch", "rwkv6-3b", "--reduced", "--device", "cpu", "--batch", "4", "--seq", "16"]


@pytest.fixture(autouse=True)
def keep_signal_handlers():
    """main() installs its preemption guard on SIGTERM/SIGINT: give the test
    process its own handlers back."""
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    yield
    for sig, handler in saved.items():
        signal.signal(sig, handler)


@pytest.mark.parametrize("data_path", ["synthetic", "pages"])
def test_main_trains_on_both_data_paths(tmp_path, capsys, data_path):
    hist = train_cli.main(ARGS + ["--steps", "3", "--ckpt-dir", str(tmp_path),
                                  "--data-path", data_path, "--remat", "full",
                                  "--bench-out", str(tmp_path / "b.json")])
    out = capsys.readouterr().out
    assert "[train] rwkv6-3b (reduced)" in out and "on cpu" in out
    assert len(hist) == 1 and hist[0]["step"] == 1  # log_every=10: the first step only
    assert (tmp_path / "b.json").exists()
    if data_path == "pages":
        assert (tmp_path / "tokens.heap").exists()


# the families whose batches carry patches or frames train from synthetic
# data, as in the reference (the page data path gives tokens only)
SYNTHETIC_ONLY = ("seamless-m4t-medium", "internvl2-26b")


@pytest.mark.parametrize("arch", ["minicpm3-4b", "internlm2-20b"] + list(SYNTHETIC_ONLY))
def test_main_trains_the_attention_families(tmp_path, capsys, arch):
    """An MLA and a GQA model through the attention training forward, from
    token pages with full rematerialisation; the enc-dec and the VLM model
    from synthetic data (their frames and patches)."""
    data_path = "synthetic" if arch in SYNTHETIC_ONLY else "pages"
    hist = train_cli.main(["--arch", arch] + ARGS[2:] + [
        "--steps", "2", "--ckpt-dir", str(tmp_path), "--data-path", data_path,
        "--remat", "full"])
    assert f"[train] {arch} (reduced)" in capsys.readouterr().out
    assert len(hist) == 1 and torch.isfinite(torch.tensor(hist[0]["loss"]))


@pytest.mark.parametrize("arch,missing", [("seamless-m4t-medium", "frames"),
                                          ("internvl2-26b", "patches")])
def test_main_on_pages_raises_the_references_key_error(tmp_path, arch, missing):
    """``--data-path pages`` gives these families no frames or patches: the
    reference's launcher raises ``KeyError`` there, and so does the port's
    (ROADMAP §C, reference quirks)."""
    with pytest.raises(KeyError, match=missing):
        train_cli.main(["--arch", arch] + ARGS[2:] + [
            "--steps", "1", "--ckpt-dir", str(tmp_path), "--data-path", "pages"])


def test_main_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "rwkv6-3b", "--reduced", "--steps", "1"])


def test_main_resumes_from_its_checkpoint_dir(tmp_path):
    train_cli.main(ARGS + ["--steps", "4", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    assert ckpt.latest_step(str(tmp_path)) == 4
    hist = train_cli.main(ARGS + ["--steps", "6", "--ckpt-every", "2",
                                  "--ckpt-dir", str(tmp_path)])
    assert hist[0]["step"] == 5  # resumed after step 4
    assert ckpt.latest_step(str(tmp_path)) == 6


def test_microbatch_is_parsed_and_not_used(tmp_path, monkeypatch):
    """The reference parses --microbatch and never passes it on; so does the
    port (recorded in ROADMAP §C)."""
    seen = []
    real = train_loop.make_train_step

    def spy(loss_fn, opt_cfg, compress=None, microbatches=1):
        seen.append(microbatches)
        return real(loss_fn, opt_cfg, compress=compress, microbatches=microbatches)

    monkeypatch.setattr(train_loop, "make_train_step", spy)
    train_cli.main(ARGS + ["--steps", "1", "--microbatch", "2", "--ckpt-dir", str(tmp_path)])
    assert seen == [1]
    # the reference's main reads every other flag it defines, never this one
    from repro.launch import train as jtrain

    src = inspect.getsource(jtrain.main)
    assert '"--microbatch"' in src and "args.microbatch" not in src
    assert "args.grad_compression" in src and "args.remat" in src
