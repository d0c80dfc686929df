"""Helpers of the port's serving tests (``test_torch_serv*.py``,
``test_torch_models.py``, ``test_torch_launch_serve.py``; the training tests
import the one-thread fixture too): the port's own
reduced models on the CPU, a stream runner, the one-thread fixture, and the
greedy comparison against ``repro`` that allows near-ties (tested below)."""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.models import model_zoo
from repro_torch.serve.serving import BatchedServer, Request

CPU = "cpu"
# the most the two packages' greedy logits may deviate (spread over the vocab
# of their difference) for a divergence to pass as a near-tie: twice the bf16
# logit tolerance of test_torch_models.py. The deviation is measured on the
# port under test, so without a limit a wrong port would excuse its own
# divergences.
DEVIATION_LIMIT = 2 * 5e-2

# more requests than slots, so finished slots free their blocks and later
# admissions recycle them
STREAM = [([5, 6, 7, 8], 9), ([1, 2], 3), ([9, 3, 9, 4], 5), ([2, 7], 4),
          ([8, 1, 6], 6), ([4, 4, 4, 4, 4], 3)]


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """The tests' shapes are tiny: one intra-op thread runs each op in tens of
    microseconds, where a thread pool spends milliseconds waking up. Imported
    into each serving test module, which it applies to."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def params(arch="internlm2-20b", seed=2):
    """A reduced config and the port's own weights for it, drawn on the CPU
    (read-only: the server never writes its parameters)."""
    cfg = get_reduced_config(arch)
    return cfg, model_zoo.init_params(cfg, seed=seed, device=CPU)[0]


def serve(cfg, params, stream=STREAM, slots=2, max_seq=24, **kw):
    srv = BatchedServer(cfg, params, batch_slots=slots, max_seq=max_seq, device=CPU, **kw)
    for i, (p, n) in enumerate(stream):
        srv.submit(Request(i, list(p), n))
    return [r.out for r in srv.run()], srv


def _teacher_forced_logits(decode, params, cache, seq, make_tok, to_numpy):
    out = []
    for pos, tok in enumerate(seq):
        logits, cache = decode(params, make_tok([tok]), cache, pos)
        out.append(to_numpy(logits)[0])
    return np.stack(out)


def assert_greedy_matches(cfg, tparams, jcfg, jparams, prompt, got, want,
                          limit=DEVIATION_LIMIT, jdecode=None):
    """``got`` (the port's greedy tokens) equals ``want`` (``repro``'s) except
    at a near-tie: at the first token where they differ, the reference's
    top-2 logit margin must be below the logits' measured deviation. The
    deviation is the largest spread (max minus min over the vocab) of the
    difference between the two packages' logits, teacher-forced along the
    common history; a margin can move by no more than that. The deviation
    itself must stay within ``limit`` (DEVIATION_LIMIT unless the family's
    logit bound is wider). ``jdecode`` is the reference's decode function
    (default ``decode_fn(jcfg)``, run op by op; a jitted one, as ``repro``'s
    server runs it, takes a fraction of the time on long histories). Returns
    None when the tokens agree, else (index, margin, deviation)."""
    import jax.numpy as jnp
    from repro.models import model_zoo as jzoo

    assert len(got) == len(want)
    if got == want:
        return None
    k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    seq = list(prompt) + list(want[:k])
    jl = _teacher_forced_logits(jdecode or jzoo.decode_fn(jcfg), jparams,
                                jzoo.make_cache(jcfg, 1, len(seq)), seq,
                                lambda t: jnp.asarray(t, jnp.int32),
                                lambda x: np.asarray(x, np.float32))
    tl = _teacher_forced_logits(model_zoo.decode_fn(cfg), tparams,
                                model_zoo.make_cache(cfg, 1, len(seq), CPU), seq,
                                lambda t: torch.tensor(t, dtype=torch.int32),
                                lambda x: x.float().numpy())
    v = cfg.vocab_size
    top = np.sort(jl[-1, :v])
    margin = float(top[-1] - top[-2])
    delta = tl[:, :v] - jl[:, :v]
    deviation = float((delta.max(axis=1) - delta.min(axis=1)).max())
    assert deviation <= limit, ("logits deviate", k, deviation, limit)
    assert margin < deviation, (k, margin, deviation, got, want)
    print(f"near-tie at token {k}: reference margin {margin:.4g} < deviation {deviation:.4g}")
    return k, margin, deviation


def test_greedy_comparison_allows_only_near_ties():
    """Equal tokens pass without a look at the logits; a token that leaves
    the reference's where its top-2 margin is wide fails."""
    import jax
    from repro.configs import get_reduced_config as jreduced
    from repro.models import model_zoo as jzoo
    from repro.serve import serving as jserving

    from repro_torch.models.params import params_from_numpy

    arch = "mistral-nemo-12b"
    cfg, jcfg = get_reduced_config(arch), jreduced(arch)
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(5))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device=CPU)
    prompt = [5, 6, 7, 8, 2, 1, 9]
    (want,) = jserving.generate_greedy(jcfg, jp, [prompt], 3)
    assert assert_greedy_matches(cfg, tp, jcfg, jp, prompt, list(want), want) is None
    wrong = [(want[0] + 1) % cfg.vocab_size] + list(want[1:])
    with pytest.raises(AssertionError):
        assert_greedy_matches(cfg, tp, jcfg, jp, prompt, wrong, want)


def test_greedy_comparison_bounds_the_deviation():
    """A port whose logits leave the reference's by more than the limit
    (here: other weights) fails on its deviation, however small the
    reference's margin at the divergence."""
    import jax
    from repro.configs import get_reduced_config as jreduced
    from repro.models import model_zoo as jzoo
    from repro.serve import serving as jserving

    from repro_torch.models.params import params_from_numpy

    arch = "mistral-nemo-12b"
    cfg, jcfg = get_reduced_config(arch), jreduced(arch)
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(5))
    other, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(6))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, other), device=CPU)
    prompt = [5, 6, 7, 8, 2, 1, 9]
    (want,) = jserving.generate_greedy(jcfg, jp, [prompt], 3)
    wrong = [(want[0] + 1) % cfg.vocab_size] + list(want[1:])
    with pytest.raises(AssertionError, match="logits deviate"):
        assert_greedy_matches(cfg, tp, jcfg, jp, prompt, wrong, want)
