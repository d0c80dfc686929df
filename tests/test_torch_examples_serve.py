"""``repro_torch.launch.serve_lm`` (the port of ``examples/serve_lm.py``)
against ``repro``'s same flow, written out here: for each of the example's
three archs (internlm2-20b, minicpm3-4b and rwkv6-3b, reduced), ``repro``'s
``PRNGKey(1)`` weights carried across by ``params_from_numpy`` as the f32
tree they are (both packages cast at each use; RWKV's f32 projections read
the f32 values, as in ``test_torch_serving_hybrid.py``), and
both packages' ``BatchedServer`` serving the example's 8 prompts (numpy seed
0, drawn arch after arch) greedily: the same tokens, up to near-ties
(``assert_greedy_matches``, the reference's decode jitted as its server runs
it; the deviation limit twice the family's bf16 logit bound, as in
``test_torch_serving_hybrid.py``: DEVIATION_LIMIT, and for rwkv6-3b twice
``test_torch_rwkv.BF16_LOGITS``, whose bf16 time mix rounds at other places
in the two packages; the first divergence stops that comparison). With f32
activations in both packages the same 8 x 48 greedy tokens of each arch are
held exactly, every one of them. The port's sampled run at the example's 0.7
is held by the example's counts (``test_torch_examples_cli.py``); paged KV
on the gather path gives the dense run's greedy tokens."""
import jax
import numpy as np
import pytest
import torch

from repro_torch.launch import serve_lm
from repro_torch.models.params import params_from_numpy
from test_torch_rwkv import BF16_LOGITS as RWKV_BF16_LOGITS
from test_torch_attention import _uncast
from test_torch_serve_util import (DEVIATION_LIMIT, assert_greedy_matches,  # noqa: F401
                                   one_cpu_thread)

RWKV_LIMIT = 2 * RWKV_BF16_LOGITS["atol"]


def _repro_flow(weights):
    """``examples/serve_lm.py``'s loop through ``repro`` at temperature 0:
    each arch's tokens by request, and each prompt."""
    from repro.configs import get_reduced_config
    from repro.serve.serving import BatchedServer, Request

    rng = np.random.default_rng(serve_lm.PROMPT_SEED)
    outs, prompts = {}, {}
    for arch in serve_lm.ARCHS:
        cfg = get_reduced_config(arch)
        server = BatchedServer(cfg, weights[arch], batch_slots=8, max_seq=96,
                               temperature=0.0, seed=0)
        prompts[arch] = [rng.integers(1, cfg.vocab_size, 16).tolist() for _ in range(8)]
        for i, prompt in enumerate(prompts[arch]):
            server.submit(Request(rid=i, prompt=prompt, max_new_tokens=48))
        outs[arch] = {r.rid: list(r.out) for r in server.run()}
    return outs, prompts


def _args(*extra):
    return serve_lm.build_parser().parse_args(["--device", "cpu", "--temperature", "0", *extra])


@pytest.fixture(scope="module")
def greedy():
    """repro's weights for each arch, both packages' greedy tokens, and the
    port's weights carried across."""
    from repro.configs import get_reduced_config as jreduced
    from repro.models import model_zoo as jzoo

    from repro_torch.configs import get_reduced_config

    jweights, tweights = {}, {}
    for arch in serve_lm.ARCHS:
        jweights[arch], _ = jzoo.init_params(jreduced(arch), jax.random.PRNGKey(1))
        tweights[arch] = params_from_numpy(get_reduced_config(arch),
                                           jax.tree.map(np.asarray, jweights[arch]),
                                           device="cpu", dtype=torch.float32)
    want, prompts = _repro_flow(jweights)
    got = serve_lm.flow(_args(), params=tweights)
    return got, want, prompts, jweights, tweights


@pytest.mark.parametrize("arch", serve_lm.ARCHS)
def test_greedy_tokens_match_repro(greedy, arch):
    from repro.configs import get_reduced_config as jreduced
    from repro.models import model_zoo as jzoo

    from repro_torch.configs import get_reduced_config

    got, want, prompts, jweights, tweights = greedy
    run = got["archs"][arch]
    assert run["tokens"] == 8 * 48 and run["attn_impl"] == "gather"
    assert sorted(run["outs"]) == sorted(want[arch]) == list(range(8))
    cfg, jcfg = get_reduced_config(arch), jreduced(arch)
    limit = RWKV_LIMIT if cfg.family == "ssm" else DEVIATION_LIMIT
    jdecode = jax.jit(jzoo.decode_fn(jcfg))
    for rid, prompt in enumerate(prompts[arch]):
        assert_greedy_matches(cfg, tweights[arch], jcfg, jweights[arch], prompt,
                              run["outs"][rid], want[arch][rid], limit=limit, jdecode=jdecode)


@pytest.fixture(scope="module")
def greedy_f32(greedy):
    """Both packages' greedy tokens on the same weights with f32 activations."""
    bf16, _, _, jweights, tweights = greedy
    with pytest.MonkeyPatch.context() as mp:
        _uncast(mp)
        want, _ = _repro_flow(jweights)
        got = serve_lm.flow(_args(), params=tweights)
    return got, want, bf16


@pytest.mark.parametrize("arch", serve_lm.ARCHS)
def test_greedy_tokens_match_repro_in_f32(greedy_f32, arch):
    """Every served token of every request is ``repro``'s with f32
    activations, where the logits agree to 1e-5 (test_torch_rwkv's f32
    prefill bound) and the bf16 near-ties that the test above allows for are
    gone; and the f32 run serves other tokens than the bf16 one, so the
    activations were f32."""
    got, want, bf16 = greedy_f32
    run = got["archs"][arch]
    assert run["tokens"] == 8 * 48
    assert run["outs"] == want[arch]
    assert run["outs"] != bf16["archs"][arch]["outs"]


def test_paged_gather_gives_the_dense_greedy_tokens(greedy):
    """``--kv paged`` on the gather path: every arch's tokens the dense
    run's (rwkv6-3b has no KV and serves dense, with the fallback
    recorded)."""
    got, _, _, _, tweights = greedy
    paged = serve_lm.flow(_args("--kv", "paged"), params=tweights)
    assert paged["lines"][-1] == "OK"
    for arch in serve_lm.ARCHS:
        assert paged["archs"][arch]["outs"] == got["archs"][arch]["outs"], arch
        assert paged["archs"][arch]["kv"] == ("dense" if arch == "rwkv6-3b" else "paged")
        assert got["archs"][arch]["kv"] == "dense"


def test_flow_serves_the_chosen_archs_at_the_chosen_depth():
    """``--arch`` picks the archs (in their order, the prompts drawn arch
    after arch) and ``--layers`` cuts the depth."""
    out = serve_lm.flow(_args("--arch", "rwkv6-3b", "--layers", "1"))
    assert list(out["archs"]) == ["rwkv6-3b"]
    assert out["archs"]["rwkv6-3b"]["layers"] == 1
    assert out["archs"]["rwkv6-3b"]["tokens"] == 8 * 48
