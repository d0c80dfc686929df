"""Fallback registry of the distribution layer (counterpart of
``repro.dist.meshes``, lines 233-271, which it is held against).

The port runs on one card, so there is no mesh: ``repro``'s ``shard_act``
constraints are the identity here and the port's model code leaves them out,
and every entry point that takes ``mesh=`` raises ``NotImplementedError``
through ``no_mesh`` until the distribution slice (ROADMAP A19). What stays
is the report of decisions a caller made against what it was asked for (a
server that serves gather attention where the kernel was asked for, or
chunked stepping where token stepping was), which callers record with ``record_fallback`` and read with ``fallbacks()``.

The log is per thread, as in ``repro``; with no ``use_mesh`` block to scope
it, ``clear_fallbacks`` starts a fresh report.
"""
from __future__ import annotations

import threading

_STATE = threading.local()


def _fallback_log() -> list:
    log = getattr(_STATE, "fallbacks", None)
    if log is None:
        log = _STATE.fallbacks = []
    return log


def fallbacks() -> list[tuple[str | None, tuple[str, int], str]]:
    """Fallbacks recorded since ``clear_fallbacks`` (or the thread's start):
    ``(tensor_name, (logical_axis, dim), why)``."""
    return list(_fallback_log())


def clear_fallbacks() -> None:
    _fallback_log().clear()


def record_fallback(tensor_name, logical_axis, dim, why) -> None:
    """Record one fallback; an entry already in the log is not repeated."""
    entry = (tensor_name, (logical_axis, dim), why)
    log = _fallback_log()
    if entry not in log:
        log.append(entry)


def no_mesh(mesh, what: str) -> None:
    """Raise for a ``mesh=`` the port cannot serve yet."""
    if mesh is not None:
        raise NotImplementedError(
            f"{what}: meshes and sharding wait for the distribution slice "
            "(ROADMAP A19); the port runs on one card"
        )
