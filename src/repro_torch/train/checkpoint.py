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
in the stored dtype. ``restore(shardings=)`` is the elastic reshard: the
stored arrays are logical, so each is placed on any mesh by its
``NamedSharding``: this rank's slice goes to the device, with no
communication (as ``meshes.place`` places a whole tensor).

In a process group of more than one rank, ``save`` and
``AsyncCheckpointer.submit`` first make every leaf whole on every rank (a
placed leaf is gathered by broadcasts, a collective every rank calls);
global rank 0 alone writes the ``.tmp`` directory and renames it, then
every rank waits at a barrier (the async writer's at ``close``).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist import meshes


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _unflatten_into(template, data, shardings=None, prefix=""):
    """``template``'s structure filled leaf by leaf from ``data`` (the
    checkpoint's arrays, memory maps read one at a time), each leaf on its
    template leaf's device; with ``shardings`` only this rank's slice of a
    leaf is read and goes to the device."""
    sub = (lambda k: None) if shardings is None else (lambda k: shardings[k])
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], data, sub(k), f"{prefix}{k}/") for k in template}
    if isinstance(template, (list, tuple)):
        out = [_unflatten_into(v, data, sub(i), f"{prefix}{i}/") for i, v in enumerate(template)]
        return type(template)(out) if isinstance(template, tuple) else out
    arr = data[prefix[:-1].replace("/", "__")]
    device = meshes.local(template).device if isinstance(template, torch.Tensor) else "cpu"
    if shardings is None:
        return torch.from_numpy(np.array(arr)).to(device)
    # this rank's slice alone is read (a memory map of the member) and copied
    part = np.array(arr if shardings.is_replicated
                    else arr[meshes.shard_slices(arr.shape, shardings)])
    return meshes.from_local(torch.from_numpy(part).to(device), shardings, tuple(arr.shape))


def _members(path: str):
    """The arrays of an ``np.savez`` file by key, each a read-only memory
    map of its member: both packages write their checkpoints with
    ``np.savez``, which stores members uncompressed. Anything else raises
    ``ValueError``."""
    import struct
    import zipfile

    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED or not info.filename.endswith(".npy"):
                raise ValueError(f"{path}: {info.filename} is not an uncompressed .npy member")
            f.seek(info.header_offset)
            name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            if version not in ((1, 0), (2, 0)):
                raise ValueError(f"{path}: {info.filename} has .npy format {version}")
            shape, fortran, dtype = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                                     else np.lib.format.read_array_header_2_0)(f)
            if dtype.hasobject:
                raise ValueError(f"{path}: {info.filename} holds Python objects")
            key = info.filename[:-len(".npy")]
            if not shape or 0 in shape:  # nothing to map
                n = int(np.prod(shape))
                out[key] = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype).reshape(shape)
            else:
                out[key] = np.memmap(path, dtype=dtype, mode="r", offset=f.tell(), shape=shape,
                                     order="F" if fortran else "C")
    return out


def _ranks() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _writer() -> bool:
    """Whether this process writes: always alone, global rank 0 in a group."""
    return _ranks() == 1 or dist.get_rank() == 0


def _host_copy(leaf, keep: bool = True) -> np.ndarray | None:
    """A numpy array of ``leaf`` that shares no memory with it (a placed
    leaf made whole first, by every rank); None where ``keep`` is false."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype; checkpoint the f32 masters")
        if meshes.is_dtensor(leaf):  # gathered through the host: a fresh host tensor
            leaf = meshes.whole(leaf, device="cpu")
            return leaf.detach().numpy() if keep else None
        return leaf.detach().to("cpu", copy=True).numpy() if keep else None
    return np.array(leaf) if keep else None


def _to_host(tree, keep: bool = True):
    """``tree`` with every leaf whole on the host, in ``_flatten``'s order
    (the order of the collectives on a mesh)."""
    return {name: _host_copy(leaf, keep) for name, leaf in _flatten(tree)}


def save(ckpt_dir: str, step: int, state: dict) -> str:
    """Atomic checkpoint write. ``state`` is any tree (dicts, lists) of
    tensors or arrays. In a group of ranks every rank calls it: rank 0
    writes, then all meet at a barrier."""
    arrays = _to_host(state, keep=_writer())
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _writer():
        _write(ckpt_dir, step, arrays)
    if _ranks() > 1:
        meshes.barrier()
    return final


def _np_dtype(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def manifest(state) -> dict:
    """The ``arrays`` entry of the manifest a save of ``state`` writes:
    dtype and logical shape by path (placed leaves count whole)."""
    return {name: {"dtype": _np_dtype(leaf), "shape": list(np.shape(leaf))
                   if not isinstance(leaf, torch.Tensor) else list(leaf.shape)}
            for name, leaf in _flatten(state)}


def _write(ckpt_dir: str, step: int, host: dict) -> str:
    """Write the leaves ``host`` (path -> numpy array) atomically."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{name.replace("/", "__"): arr for name, arr in host.items()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "arrays": manifest(host)}, f)
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


def restore(ckpt_dir: str, template, step: int | None = None, shardings=None):
    """Load a checkpoint into ``template``'s structure: (state, step). With
    ``shardings`` (a matching tree of ``NamedSharding``) each leaf is placed
    by its sharding, on any mesh: the elastic reshard. A ``shardings`` tree
    that does not match ``template`` raises ``ValueError``."""
    if shardings is not None:
        meshes.check_tree_shardings(template, shardings)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    members = _members(os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz"))
    return _unflatten_into(template, members, shardings), step


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
            step, host = item
            try:
                _write(self.ckpt_dir, step, host)
            except Exception as e:  # surfaced on next submit/close
                self._err = e

    def submit(self, step: int, state: dict):
        if self._err:
            raise self._err
        # copy to the host NOW: the train step updates the tensors in place
        host = _to_host(state, keep=_writer())
        if _writer():
            self._q.put((step, host))  # blocks if previous write is behind

    def close(self):
        self._q.put(None)
        self._thread.join()
        if _ranks() > 1:
            meshes.barrier()
        if self._err:
            raise self._err

