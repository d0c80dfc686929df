"""The port's LM data pipelines against ``repro.data.pipeline`` on the same
seeds: ``PageTokenDataset`` batches (token pages decoded by the strider
path) equal the reference's bit for bit over enough steps to wrap past the
heap's end, and so do ``synthetic_data_fn`` and ``lm_token_batch``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.data import pipeline as jpipeline
from repro.data.synthetic import lm_token_batch as j_lm_token_batch
from repro_torch.configs import get_reduced_config
from repro_torch.data import pipeline
from repro_torch.data.synthetic import lm_token_batch
from repro_torch.kernels.strider import ops as strider_ops

CPU = "cpu"


@pytest.mark.parametrize("step,shard", [(0, 0), (7, 0), (3, 2)])
def test_lm_token_batch_matches_repro(step, shard):
    got = lm_token_batch(step, 4, 33, 503, shard)
    want = j_lm_token_batch(step, 4, 33, 503, shard)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("vocab", [503, 65536])
def test_page_batches_equal_repro_bit_for_bit(tmp_path, vocab):
    # 20 sequences of 2 x 64 tokens on 4 KB pages: the heap spans several
    # pages, and batches of 6 wrap past its end
    kw = dict(n_seqs=20, seq_len=64, vocab=vocab, seed=1, page_bytes=4096)
    mine = pipeline.PageTokenDataset(str(tmp_path / "t.heap"), device=CPU, **kw)
    ref = jpipeline.PageTokenDataset(str(tmp_path / "j.heap"), **kw)
    assert mine.heap.n_pages == ref.heap.n_pages > 2
    np.testing.assert_array_equal(mine.heap.read_all(), ref.heap.read_all())
    wrapped = False
    for step in (0, 1, 2, 3, 4, 7, 2):  # sequential, then a jump back (refetch)
        got, want = mine.batch(step, 6), ref.batch(step, 6)
        wrapped |= (step + 1) * 6 > kw["n_seqs"]
        for k in ("tokens", "targets"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got["loss_mask"].numpy(), np.asarray(want["loss_mask"]))
    assert wrapped


def test_denormal_tokens_survive_the_page_path(tmp_path):
    """Tokens below 2**23 are f32 denormals: only bit copies keep them."""
    ds = pipeline.PageTokenDataset(str(tmp_path / "t.heap"), n_seqs=8, seq_len=16,
                                   vocab=1 << 20, seed=0, device=CPU)
    feats = strider_ops.decode_pages(strider_ops.pages_tensor(ds.heap.read_all()),
                                     ds.heap.layout)[0]
    assert (feats.view(torch.int32) != 0).any()
    b = ds.batch(0, 8)
    seqs = feats.view(torch.int32).reshape(-1, 32)[:8]
    assert torch.equal(b["tokens"], seqs[:, :16]) and torch.equal(b["targets"], seqs[:, 16:])
    assert int(b["tokens"].min()) >= 1 and int(b["tokens"].max()) < (1 << 23)


@pytest.mark.parametrize("shard", [0, 1])
def test_synthetic_data_fn_matches_repro(shard):
    cfg, jcfg = get_reduced_config("rwkv6-3b"), jreduced("rwkv6-3b")
    fn = pipeline.synthetic_data_fn(cfg, 3, 24, shard, device=CPU)
    jfn = jpipeline.synthetic_data_fn(jcfg, 3, 24, shard)
    for step in range(3):
        got, want = fn(step), jfn(step)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_synthetic_data_fn_refuses_extra_inputs():
    """The extra inputs, bit for bit: internvl2-26b's text cut to seq -
    vis_tokens beside its patches, seamless-m4t-medium's frames, and both
    on a config of another family given ``vis_tokens``."""
    vlm = dataclasses.replace(get_reduced_config("rwkv6-3b"), vis_tokens=4)
    jvlm = dataclasses.replace(jreduced("rwkv6-3b"), vis_tokens=4)
    extra = {"internvl2-26b": {"patches"}, "seamless-m4t-medium": {"frames"}, "rwkv": {"patches"}}
    for name, cfg, jcfg in [(a, get_reduced_config(a), jreduced(a))
                            for a in ("internvl2-26b", "seamless-m4t-medium")] + [
            ("rwkv", vlm, jvlm)]:
        fn = pipeline.synthetic_data_fn(cfg, 3, 24, 1, device=CPU)
        jfn = jpipeline.synthetic_data_fn(jcfg, 3, 24, 1)
        for step in (0, 2):
            got, want = fn(step), jfn(step)
            assert set(got) == set(want) == {"tokens", "targets", "loss_mask"} | extra[name]
            for k in want:
                assert got[k].dtype == getattr(torch, str(want[k].dtype)), (name, k)
                assert got[k].shape == want[k].shape, (name, k)
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                              err_msg=f"{name} {k}")
        assert got["tokens"].shape[1] == 24 - cfg.vis_tokens


@pytest.mark.parametrize("arch,missing", [("seamless-m4t-medium", "frames"),
                                          ("internvl2-26b", "patches")])
def test_page_batches_lack_the_extra_inputs_in_both_packages(tmp_path, arch, missing):
    """A reference quirk, kept (ROADMAP §C): the page data path gives tokens,
    targets and the loss mask only, so either family's loss raises
    ``KeyError`` on a page batch in both packages."""
    import jax

    from repro.models import model_zoo as jzoo
    from repro_torch.models import model_zoo

    cfg, jcfg = get_reduced_config(arch), jreduced(arch)
    kw = dict(n_seqs=8, seq_len=16, vocab=cfg.vocab_size, seed=0, page_bytes=4096)
    mine = pipeline.PageTokenDataset(str(tmp_path / "t.heap"), device=CPU, **kw).batch(0, 2)
    ref = jpipeline.PageTokenDataset(str(tmp_path / "j.heap"), **kw).batch(0, 2)
    assert set(mine) == set(ref) == {"tokens", "targets", "loss_mask"}
    params, _ = model_zoo.init_params(cfg, device=CPU)
    jparams, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    with pytest.raises(KeyError, match=missing):
        model_zoo.loss_fn(cfg, "none")(params, mine)
    with pytest.raises(KeyError, match=missing):
        jzoo.loss_fn(jcfg, "none")(jparams, ref)
