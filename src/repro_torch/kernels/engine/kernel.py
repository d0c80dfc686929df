"""Bindings of the Hopper GLM kernels: the gradient and SGD walk over merge
batches (``csrc/glm_grad.cu``, B2) and row-parallel scoring
(``csrc/glm_predict.cu``, B4).

They replace ``repro.kernels.engine.engine.glm_grad_pallas`` (with the scan
over merge batches that ``repro.core.engine`` runs around it) and
``glm_predict_pallas`` (the Pallas ``_glm_kernel`` and
``_glm_predict_kernel``). Each library is built at first use; a wrapper
checks its inputs, allocates its outputs and scratch with ``torch.empty``,
launches on the current stream and never synchronises.
``glm_sgd_chunk.launches`` counts the walks over a chunk's merge batches (one
CUDA launch each), ``glm_grad.launches`` the one-batch gradients (the same
kernel, one launch) and ``glm_predict.launches`` the scoring kernel's.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build

_ACT_CODES = {"linear": 0, "logistic": 1, "svm": 2}


@functools.cache
def _entry():
    lib = build.load("glm_grad")
    grad = lib.glm_grad
    grad.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    grad.restype = ctypes.c_int
    chunk = lib.glm_sgd_chunk
    chunk.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
                      + [ctypes.c_void_p])
    chunk.restype = ctypes.c_int
    lib.glm_sgd_max_smem_width.argtypes = []
    lib.glm_sgd_max_smem_width.restype = ctypes.c_int
    return lib, grad, chunk, lib.glm_sgd_max_smem_width()


def _work(d: int, max_width: int, device) -> torch.Tensor | None:
    """The kernel's scratch for w, g and g's compensation where they do not
    fit in shared memory (d > max_width), or None when none is needed."""
    if d <= max_width:
        return None
    return torch.empty((3 * d,), dtype=torch.float32, device=device)


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def _check(what: str, act: str, x: torch.Tensor, mask_dtypes=(torch.float32,),
           **vectors) -> tuple[int, int]:
    """Validate x (N, D) and the named vectors, each given with its length
    ("n" or "d"): f32 (``mask`` of one of ``mask_dtypes``), contiguous, on
    x's card. Returns (N, D)."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown GLM activation {act!r}")
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (N, D), got {tuple(x.shape)}")
    n, d = x.shape
    for name, (t, dim) in {"x": (x, None), **vectors}.items():
        shape = (n, d) if dim is None else ({"n": n, "d": d}[dim],)
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        dtypes = mask_dtypes if name == "mask" else (torch.float32,)
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n, d


def glm_grad(
    x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, mask: torch.Tensor, act: str
) -> torch.Tensor:
    """x (N, D), y (N,), w (D,), mask (N,), all f32, contiguous and on one
    card -> X' (err(X w, y) * mask), (D,) f32."""
    n, d = _check("glm_grad", act, x, y=(y, "n"), w=(w, "d"), mask=(mask, "n"))
    out = torch.empty((d,), dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return out.zero_()
    lib, fn, _, max_width = _entry()
    work = _work(d, max_width, x.device)
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), y.data_ptr(), w.data_ptr(), mask.data_ptr(), out.data_ptr(),
            _ptr(work), n, d, _ACT_CODES[act],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(lib, err, "glm_grad launch")
    glm_grad.launches += 1
    return out


glm_grad.launches = 0


def glm_sgd_chunk(
    x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
    coef: int, act: str, a: float, b: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SGD over the merge batches of ``coef`` rows of x (N, D), y (N,),
    mask (N,), in order, from w (D,), all f32, contiguous and on one card:
    per batch g = X_b' (err(X_b w, y_b) * mask_b), then w <- a*w - b*g (a and
    b rounded to f32). Returns (w, each batch's |g|, (ceil(N / coef),) f32);
    the last batch holds the rows left over."""
    if isinstance(coef, bool) or not isinstance(coef, int) or coef < 1:
        raise ValueError(f"coef must be a positive int, got {coef!r}")
    n, d = _check("glm_sgd_chunk", act, x, y=(y, "n"), w=(w, "d"), mask=(mask, "n"))
    gnorms = torch.empty((-(-n // coef),), dtype=torch.float32, device=x.device)
    if n == 0:
        return w.clone(), gnorms
    if d == 0:
        return w.clone(), gnorms.zero_()
    w_out = torch.empty((d,), dtype=torch.float32, device=x.device)
    lib, _, fn, max_width = _entry()
    work = _work(d, max_width, x.device)
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), y.data_ptr(), mask.data_ptr(), w.data_ptr(), w_out.data_ptr(),
            gnorms.data_ptr(), _ptr(work), n, d, coef, _ACT_CODES[act],
            a, b, torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(lib, err, "glm_sgd_chunk launch")
    glm_sgd_chunk.launches += 1
    return w_out, gnorms


glm_sgd_chunk.launches = 0


# B4's launch geometry (csrc/glm_predict.cu): kConsumerWarps and kBarrierBytes
# of the kernel, and the default launch, the fastest of those timed at the
# scan's chunk on an H100: tiles of up to 128 rows, two stages of up to 37 KB,
# three CTAs an SM (kMinBlocks). Rows too wide for 4 in a stage take the wide
# body.
PREDICT_CONSUMER_WARPS = 8
PREDICT_BARRIER_BYTES = 64
PREDICT_TILE_ROWS = 128
PREDICT_STAGE_FLOATS = 9_472
PREDICT_STAGES = 2
PREDICT_CTAS_PER_SM = 3
PREDICT_ZCACHE = 8  # kZCache: features a lane holds in registers
PREDICT_BODIES = {"staged_few": 0, "staged_many": 1, "wide": 2}


@dataclasses.dataclass(frozen=True)
class PredictPlan:
    """B4's launch: ``tiles`` tiles of ``rows`` consecutive rows (the last
    ragged), CTA b of ``grid`` taking tiles b, b + grid, ... Staged bodies
    stream each tile's rows of X through a ring of ``stages`` stages of
    ``stage_bytes``, a row on ``lanes`` lanes; the wide body scores a row a
    consumer warp in place (``rows`` is then the warps of a CTA)."""

    n: int
    d: int
    body: str
    rows: int
    tiles: int
    stages: int
    lanes: int
    grid: int
    stage_bytes: int
    smem_bytes: int

    def tiles_of(self, cta: int) -> list[tuple[int, int]]:
        """(first row, rows) of each tile CTA ``cta`` takes, in its order."""
        return [(t * self.rows, min(self.rows, self.n - t * self.rows))
                for t in range(cta, self.tiles, self.grid)]


def _round(v: int, m: int) -> int:
    return -(-v // m) * m


def glm_predict_plan(n: int, d: int, sms: int = 132) -> PredictPlan:
    """B4's launch geometry for x (n, d) on a card of ``sms`` SMs, n >= 1.

    A tile is the most rows, a multiple of 4 and at most ``PREDICT_TILE_ROWS``,
    whose X fits in a stage of ``PREDICT_STAGE_FLOATS`` (less 3 words of
    alignment slack); a multiple of 4 keeps each tile 16-byte aligned when x
    is. Where a stage holds fewer than 4 rows, the wide body. The grid is
    ``PREDICT_CTAS_PER_SM`` persistent CTAs an SM, or one a tile when there
    are fewer tiles."""
    if n < 1 or d < 0:
        raise ValueError(f"glm_predict_plan needs n >= 1 and d >= 0, got {n}, {d}")
    fit = (PREDICT_STAGE_FLOATS - 3) // max(d, 1) & ~3
    grid = sms * PREDICT_CTAS_PER_SM
    if fit < 4:
        r = PREDICT_CONSUMER_WARPS
        tiles = -(-n // r)
        return PredictPlan(n, d, "wide", r, tiles, 0, 32, min(tiles, grid), 0, 0)
    r = min(fit, PREDICT_TILE_ROWS, _round(n, 4))
    lanes = 1
    while lanes < 32 and lanes * PREDICT_ZCACHE < d:
        lanes *= 2
    body = "staged_few" if lanes * PREDICT_ZCACHE >= d else "staged_many"
    stage_bytes = _round(4 * (r * d + 3), 16)  # + 3 words: a span lands at its alignment
    tiles = -(-n // r)
    return PredictPlan(n, d, body, r, tiles, PREDICT_STAGES, lanes, min(tiles, grid),
                       stage_bytes, PREDICT_BARRIER_BYTES + PREDICT_STAGES * stage_bytes)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_plan = functools.lru_cache(maxsize=256)(glm_predict_plan)


@functools.cache
def _predict_entry():
    lib = build.load("glm_predict")
    fn = lib.glm_predict
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def glm_predict(
    x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor, act: str
) -> torch.Tensor:
    """x (N, D) and w (D,) f32, mask (N,) f32 or bool, all contiguous and on
    one card -> where(mask > 0, act(X w), 0), (N,) f32, launched as
    ``glm_predict_plan(N, D)`` says."""
    n, d = _check("glm_predict", act, x, (torch.float32, torch.bool), w=(w, "d"),
                  mask=(mask, "n"))
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    plan = _plan(n, d, _sm_count(x.device))
    lib, fn = _predict_entry()
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), w.data_ptr(), mask.data_ptr(), out.data_ptr(),
            n, d, _ACT_CODES[act], mask.element_size(), PREDICT_BODIES[plan.body],
            plan.rows, plan.tiles, plan.stages, plan.lanes, plan.grid, plan.stage_bytes,
            plan.smem_bytes,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(lib, err, "glm_predict launch")
    glm_predict.launches += 1
    return out


glm_predict.launches = 0
