"""Checkpointing: atomic, async-capable (counterpart of
``repro.train.checkpoint``, which it is held against).

The on-disk format is the reference's: a directory ``step_XXXXXXXX`` holding
``arrays.npz`` (one array per leaf, keyed by its path with ``/`` written as
``__``) and ``manifest.json`` (step, dtype and shape per path), so a
checkpoint written by either package restores into the other.

  * writes are atomic (temp dir + rename) so a preemption mid-write never
    corrupts the latest checkpoint,
  * ``latest_step`` + ``restore`` let a restarted job resume from the newest
    complete checkpoint,
  * ``AsyncCheckpointer`` hands the state to a background thread so the train
    loop only blocks on the previous write (one-deep pipeline). The port's
    train step updates its tensors in place, so ``submit`` copies every
    tensor to the host before it returns.

Restored leaves are tensors on the device of the template's matching leaf,
in the stored dtype. The reference's ``shardings=`` (elastic reshard onto a
mesh) waits for LM training on a mesh (ROADMAP A19b).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np
import torch


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _unflatten_into(template, flat: dict, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], flat, f"{prefix}{k}/") for k in template}
    if isinstance(template, (list, tuple)):
        out = [_unflatten_into(v, flat, f"{prefix}{i}/") for i, v in enumerate(template)]
        return type(template)(out) if isinstance(template, tuple) else out
    arr = flat[prefix[:-1]]
    device = template.device if isinstance(template, torch.Tensor) else "cpu"
    return torch.from_numpy(np.array(arr)).to(device)


def _host_copy(leaf) -> np.ndarray:
    """A numpy array of ``leaf`` that shares no memory with it."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype; checkpoint the f32 masters")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    return _host_copy(tree)


def save(ckpt_dir: str, step: int, state: dict) -> str:
    """Atomic checkpoint write. ``state`` is any tree (dicts, lists) of
    tensors or arrays."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {}
    arrays = {}
    for name, leaf in _flatten(state):
        arr = leaf if isinstance(leaf, np.ndarray) else _host_copy(leaf)
        arrays[name.replace("/", "__")] = arr
        manifest[name] = {"dtype": str(arr.dtype), "shape": list(arr.shape)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "arrays": manifest}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template, step: int | None = None):
    """Load a checkpoint into ``template``'s structure: (state, step)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {k.replace("__", "/"): data[k] for k in data.files}
    return _unflatten_into(template, flat), step


class AsyncCheckpointer:
    """One-deep asynchronous checkpoint pipeline."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Exception | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, state = item
            try:
                save(self.ckpt_dir, step, state)
            except Exception as e:  # surfaced on next submit/close
                self._err = e

    def submit(self, step: int, state: dict):
        if self._err:
            raise self._err
        # copy to the host NOW: the train step updates the tensors in place
        self._q.put((step, _to_host(state)))  # blocks if previous write is behind

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._err:
            raise self._err

