"""WKV6 inputs shared by the port's WKV tests on the CPU
(``test_torch_wkv.py``), on the card (``test_torch_cuda.py``) and by
``chip_smoke.py``'s parity phase. Numpy only, so it runs where there is no
JAX. The draws follow ``tests/test_moe_ssm.py::_wkv_inputs``."""
import numpy as np

# name -> (B, T, H, K, V, chunk, seed, log-decays)
CASES = {
    "chunk8": (2, 64, 3, 16, 16, 8, 0, "random"),
    "chunk16": (2, 64, 3, 16, 16, 16, 0, "random"),
    "chunk32": (2, 64, 3, 16, 16, 32, 0, "random"),
    "pallas_small": (2, 32, 2, 8, 8, 8, 0, "random"),
    "t16_c4": (1, 16, 2, 8, 8, 4, 11, "random"),
    "t32_c16": (1, 32, 2, 8, 8, 16, 42, "random"),
    "t64_c8": (1, 64, 2, 8, 8, 8, 97, "random"),
    "k_ne_v": (2, 32, 3, 16, 24, 8, 5, "random"),
    "clip_low": (2, 64, 3, 16, 16, 32, 1, "low"),
    "clip_high": (2, 64, 3, 16, 16, 32, 2, "high"),
    "clip_mixed": (2, 64, 3, 16, 16, 32, 3, "mixed"),
}
# the training step's shape on rwkv6-3b: batch 8 x seq 512, 40 heads of 64
FULL = (8, 512, 40, 64, 64, 32, 0, "random")
# shapes that take the forward kernel's general paths: odd chunks, chunks of
# 64, widths off its 32-wide state blocks and off the 16-byte grid, and
# prefill at the training width (two chunks)
GENERAL = {
    "odd_chunk": (1, 15, 2, 12, 20, 5, 13, "random"),
    "narrow": (2, 12, 3, 6, 10, 3, 17, "mixed"),
    "chunk64": (1, 128, 2, 16, 8, 64, 19, "random"),
    "k40_v72": (1, 64, 2, 40, 72, 16, 23, "random"),
    "prefill": (1, 64, 4, 64, 64, 32, 29, "random"),
}
LW_MIN, LW_MAX = -8.0, -1e-4  # the clip of repro.models.ssm._rwkv_inputs


def make(case):
    """(r, k, v, lw, u, s0) f32 arrays and the chunk for ``case`` (a name of
    CASES, or a tuple like FULL)."""
    b, t, h, kd, vd, chunk, seed, decays = CASES[case] if isinstance(case, str) else case
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    r, k, v = mk(b, t, h, kd), mk(b, t, h, kd), mk(b, t, h, vd)
    lw = np.clip(-np.exp(rng.normal(-1, 1, (b, t, h, kd))), LW_MIN, LW_MAX)
    if decays == "low":
        lw = np.full_like(lw, LW_MIN)
    elif decays == "high":
        lw = np.full_like(lw, LW_MAX)
    elif decays == "mixed":
        lw = np.where(rng.uniform(size=lw.shape) < 0.5, LW_MIN, LW_MAX)
    u = mk(h, kd)
    s0 = mk(b, h, kd, vd) * 0.1
    return r, k, v, lw.astype(np.float32), u, s0, chunk


def test_cases_are_valid():
    for case in (*CASES, FULL, *GENERAL.values()):
        r, k, v, lw, u, s0, chunk = make(case)
        assert r.shape[1] % chunk == 0 and v.shape[:3] == r.shape[:3]
        assert lw.min() >= LW_MIN and lw.max() <= LW_MAX
        assert s0.shape == (r.shape[0], r.shape[2], r.shape[3], v.shape[3])
