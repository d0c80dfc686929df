"""Training loop: train step, checkpoint/resume, preemption, metrics
(counterpart of ``repro.train.train_loop``, which it is held against).

The loop is deliberately thin — all math lives in the train step — and
deliberately defensive: resume-from-latest on startup, periodic +
preemption-triggered checkpoints, NaN-loss circuit breaker, deterministic
data keyed by (step, shard) so a restarted worker reproduces its shard
exactly. The step runs eagerly (the reference jits it) and reads one value
back to the host per step, the loss; logging steps also read the gradient
norm and the learning rate, as the reference does.

Under ``meshes.use_mesh`` of more than one rank, ``run`` places the weights
by ``param_specs`` (the port's own keyword: in the reference XLA places
them) under the default rules, replicated without it, and the moments by
``state_specs``; the train step then runs on the mesh (``optimizer``), a
resumed checkpoint is placed with the current mesh's shardings, and every
rank saves (rank 0 writes). ``None``, an ``AbstractMesh`` or a one-rank mesh
keep the unsharded path and its bits.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

import numpy as np

from repro_torch.dist import meshes
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.grad_compress import compress_grads, init_error_fb
from repro_torch.train.optimizer import (
    OptConfig,
    adamw_init,
    make_train_step,
    param_shardings,
    state_shardings,
)


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
    param_specs=None,
):
    """Train until total_steps, resuming from the latest checkpoint if any.

    data_fn(step) must be deterministic in step (replay-safe); on a mesh it
    gives the global batch, the same on every rank. ``params`` is updated in
    place unless a checkpoint is restored or the weights are placed on a
    mesh, whose tensors replace it. Returns (params, opt_state, history).
    """
    preemption = preemption or PreemptionGuard()
    compress = compress_grads if loop_cfg.grad_compression else None
    step_fn = make_train_step(loss_fn, opt_cfg, compress=compress)

    mesh = meshes.current_mesh()
    shardings = None
    if meshes.is_multi_rank(mesh):
        shardings = {"params": param_shardings(params, mesh, param_specs)}
        params = meshes.place_tree(params, shardings["params"])
        shardings["opt"] = state_shardings(params, opt_cfg, mesh, param_specs)
    opt_state = adamw_init(params, opt_cfg, param_specs=param_specs)
    error_fb = init_error_fb(params) if compress else None
    start_step = 0

    latest = ckpt.latest_step(loop_cfg.ckpt_dir)
    if latest is not None:
        state_template = {"params": params, "opt": opt_state}
        restored, start_step = ckpt.restore(loop_cfg.ckpt_dir, state_template,
                                            step=latest, shardings=shardings)
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
