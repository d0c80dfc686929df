"""Training loop: train step, checkpoint/resume, preemption, metrics
(counterpart of ``repro.train.train_loop``, which it is held against).

The loop is deliberately thin — all math lives in the train step — and
deliberately defensive: resume-from-latest on startup, periodic +
preemption-triggered checkpoints, NaN-loss circuit breaker, deterministic
data keyed by (step, shard) so a restarted worker reproduces its shard
exactly. The step runs eagerly (the reference jits it) and reads one value
back to the host per step, the loss; logging steps also read the gradient
norm and the learning rate, as the reference does.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

import numpy as np

from repro_torch.train import checkpoint as ckpt
from repro_torch.train.grad_compress import compress_grads, init_error_fb
from repro_torch.train.optimizer import OptConfig, adamw_init, make_train_step


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    log_every: int = 10
    async_checkpoint: bool = False
    grad_compression: bool = False
    max_consecutive_nan: int = 3


class PreemptionGuard:
    """Converts SIGTERM/SIGINT into a graceful save-and-exit flag."""

    def __init__(self, install: bool = False):
        self.requested = False
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(sig, self._handler)

    def _handler(self, signum, frame):
        self.requested = True


def run(
    loss_fn: Callable,
    params,
    data_fn: Callable[[int], dict],
    loop_cfg: TrainLoopConfig,
    opt_cfg: OptConfig = OptConfig(),
    preemption: PreemptionGuard | None = None,
    hooks: list[Callable] | None = None,
):
    """Train until total_steps, resuming from the latest checkpoint if any.

    data_fn(step) must be deterministic in step (replay-safe). ``params`` is
    updated in place unless a checkpoint is restored, whose tensors replace
    it. Returns (params, opt_state, history).
    """
    preemption = preemption or PreemptionGuard()
    compress = compress_grads if loop_cfg.grad_compression else None
    step_fn = make_train_step(loss_fn, opt_cfg, compress=compress)

    opt_state = adamw_init(params, opt_cfg)
    error_fb = init_error_fb(params) if compress else None
    start_step = 0

    latest = ckpt.latest_step(loop_cfg.ckpt_dir)
    if latest is not None:
        state_template = {"params": params, "opt": opt_state}
        restored, start_step = ckpt.restore(loop_cfg.ckpt_dir, state_template)
        params, opt_state = restored["params"], restored["opt"]

    saver = (
        ckpt.AsyncCheckpointer(loop_cfg.ckpt_dir)
        if loop_cfg.async_checkpoint
        else None
    )

    history = []
    nan_streak = 0
    t_last = time.perf_counter()

    def save_now(step):
        state = {"params": params, "opt": opt_state}
        if saver is not None:
            saver.submit(step, state)
        else:
            ckpt.save(loop_cfg.ckpt_dir, step, state)

    step = start_step
    try:
        for step in range(start_step, loop_cfg.total_steps):
            batch = data_fn(step)
            if compress:
                params, opt_state, error_fb, metrics = step_fn(
                    params, opt_state, batch, error_fb
                )
            else:
                params, opt_state, metrics = step_fn(params, opt_state, batch)

            loss = float(metrics["loss"])  # the step's one host read
            if not np.isfinite(loss):
                nan_streak += 1
                if nan_streak >= loop_cfg.max_consecutive_nan:
                    raise FloatingPointError(
                        f"loss non-finite for {nan_streak} consecutive steps"
                    )
            else:
                nan_streak = 0

            if (step + 1) % loop_cfg.log_every == 0 or step == start_step:
                now = time.perf_counter()
                rec = {
                    "step": step + 1,
                    "loss": loss,
                    "grad_norm": float(metrics["grad_norm"]),
                    "lr": float(metrics["lr"]),
                    "s_per_step": (now - t_last) / loop_cfg.log_every,
                }
                history.append(rec)
                t_last = now
                for h in hooks or []:
                    h(rec)

            if (step + 1) % loop_cfg.ckpt_every == 0:
                save_now(step + 1)
            if preemption.requested:
                save_now(step + 1)
                break
    finally:
        if saver is not None:
            saver.close()

    return params, opt_state, history
