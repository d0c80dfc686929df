"""Serving example: batched decode with KV caches over the reduced configs
of three architecture families, GQA, MLA and RWKV's O(1) state
(counterpart of ``examples/serve_lm.py``, which it is held against).

Each arch's weights are drawn by ``model_zoo.init_params(cfg, 1, device)``
(the example's key 1; a ``torch.Generator`` draws other numbers than
``PRNGKey(1)``) and served in bf16 by ``BatchedServer(batch_slots=8,
max_seq=96, temperature=0.7, seed=0)``: 8 requests of 16 prompt tokens
(numpy seed 0, drawn arch after arch) and 48 new tokens each. Sampling at
0.7 is Gumbel-max on a ``torch.Generator``, so only greedy runs
(``--temperature 0``) give ``repro``'s tokens.

At the example's settings (dense KV, the gather path) no kernel runs.
``--kv paged --attn-impl kernel`` reads the pool through B5 (on MLA through
its latent entry); ``--full-width --layers N`` serves the published width
with the depth cut to N.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm [--device cpu]
        [--arch internlm2-20b ...] [--kv paged] [--attn-impl kernel]
        [--full-width --layers 2] [--temperature 0]

``--device`` defaults to ``cuda``; without a card it raises unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

# the example's archs, sizes and seeds
ARCHS = ("internlm2-20b", "minicpm3-4b", "rwkv6-3b")
WEIGHT_SEED = 1
PROMPT_SEED = 0
SLOTS = 8
REQUESTS = 8
PROMPT_LEN = 16
MAX_NEW = 48
MAX_SEQ = 96
TEMPERATURE = 0.7
SAMPLE_SEED = 0
CACHE_KIND = {"mla": "latent (absorbed)", "gqa": "KV", "none": "O(1) recurrent state"}


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--arch", action="append", choices=list(ARCH_IDS), default=None,
                    help="an arch to serve (repeatable; default: the example's three)")
    ap.add_argument("--kv", choices=["dense", "paged"], default="dense")
    ap.add_argument("--attn-impl", choices=["gather", "kernel"], default="gather",
                    help="the paged read path: gather, or the kernel B5 (repro's pallas)")
    ap.add_argument("--full-width", action="store_true",
                    help="the published width (default: the reduced config)")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this")
    ap.add_argument("--temperature", type=float, default=TEMPERATURE)
    return ap


def model_config(args, arch):
    from repro_torch.configs import get_config, get_reduced_config

    cfg = get_config(arch) if args.full_width else get_reduced_config(arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def flow(args, params=None) -> dict:
    """Serve the example's requests for each arch on ``args.device``; prints
    its lines and returns, per arch, the tokens of each request, their
    count, the seconds and tokens/s, and the server's cache layout and read
    path. ``params`` maps an arch to its weights on the device (else drawn
    from ``WEIGHT_SEED``)."""
    import torch

    from repro_torch.core.engine import resolve_device
    from repro_torch.models import model_zoo
    from repro_torch.serve.serving import BatchedServer, Request

    device = resolve_device(args.device)
    rng = np.random.default_rng(PROMPT_SEED)
    out = {"lines": [], "archs": {}}
    for arch in args.arch or ARCHS:
        cfg = model_config(args, arch)
        if params is not None and arch in params:
            weights = params[arch]
        else:
            weights, _ = model_zoo.init_params(cfg, WEIGHT_SEED, device)
        server = BatchedServer(cfg, weights, batch_slots=SLOTS, max_seq=MAX_SEQ,
                               temperature=args.temperature, seed=SAMPLE_SEED,
                               kv=args.kv, attn_impl=args.attn_impl, device=device)
        for i in range(REQUESTS):
            prompt = rng.integers(1, cfg.vocab_size, PROMPT_LEN).tolist()
            server.submit(Request(rid=i, prompt=prompt, max_new_tokens=MAX_NEW))
        t0 = time.perf_counter()
        done = server.run()
        dt = time.perf_counter() - t0
        toks = sum(len(r.out) for r in done)
        line = (f"{arch:>18} [{CACHE_KIND[cfg.attn_kind]:>22} cache]: {toks} tokens / "
                f"{dt:.1f}s = {toks/dt:6.1f} tok/s (batch {SLOTS})")
        out["lines"].append(line)
        print(line, flush=True)
        assert len(done) == REQUESTS and toks == REQUESTS * MAX_NEW, (len(done), toks)
        out["archs"][arch] = {"tokens": toks, "seconds": dt, "tok_s": toks / dt,
                              "outs": {r.rid: list(r.out) for r in done},
                              "attn_impl": server.attn_impl, "kv": server.kv_mode,
                              "layers": cfg.n_layers}
        del server, weights
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out["lines"].append("OK")
    print("OK", flush=True)
    return out


def main(argv=None) -> dict:
    """The command line: ``flow`` on the parsed flags; returns its dict."""
    args = build_parser().parse_args(argv)
    from repro_torch.core.engine import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise here
    return flow(args)


if __name__ == "__main__":
    main()
