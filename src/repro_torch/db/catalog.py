"""RDBMS catalog: tables + compiled UDF accelerator artifacts.

Mirrors the paper's design — 'DAnA stores accelerator metadata (Strider and
execution engine instruction schedules) in the RDBMS's catalog along with the
name of a UDF to be invoked from the query'. Artifacts are stored with pickle
(schedules, hDFGs, design points) next to a JSON index.

Copy of ``repro.db.catalog``, which it is held against; the port imports nothing of ``repro``.
One difference: a language model's weights stay out of the pickle. ``repro``
pickles the whole parameter tree into the artifact (24.5 GB at
mistral-nemo-12b); here ``save_weights`` writes the tree with ``torch.save``
to ``udf_<name>.weights.pt`` beside the index, the artifact's ``params`` is a
:class:`WeightsFile` naming that file, and ``load_weights`` maps it back
(``torch.load(mmap=True)``) onto a device leaf by leaf.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle

import torch


def validate_udf_artifact(name: str, artifact) -> None:
    """Schema check for catalog UDF artifacts (register and load time).

    Compiled DSL UDFs must carry ``hdfg`` + ``partition``; language-model
    UDFs (``kind == "lm"``) must carry ``cfg`` + ``params``. Anything else
    would surface as a KeyError deep inside the query executor, so reject it
    at the catalog boundary with a pointer to the right registration helper.
    """
    if not isinstance(artifact, dict):
        raise ValueError(
            f"catalog: UDF {name!r} artifact must be a dict, "
            f"got {type(artifact).__name__}"
        )
    required = (
        {"cfg", "params"} if artifact.get("kind") == "lm"
        else {"hdfg", "partition"}
    )
    missing = required - artifact.keys()
    if missing:
        raise ValueError(
            f"catalog: UDF {name!r} artifact missing {sorted(missing)}; "
            f"register via register_udf_from_trace (DSL) or "
            f"register_lm_udf (language model)"
        )


@dataclasses.dataclass(frozen=True)
class WeightsFile:
    """An LM artifact's ``params``: the weights file ``save_weights`` wrote,
    by its name relative to the catalog's root, its size in bytes and the
    number of tensors (leaves) in the tree."""

    path: str
    nbytes: int
    n_leaves: int


def _n_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_n_leaves(v) for v in tree)
    return 1


class Catalog:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._index_path = os.path.join(root, "catalog.json")
        self._index = {"tables": {}, "udfs": {}}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)

    def _flush(self) -> None:
        tmp = self._index_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._index, f, indent=1)
        os.replace(tmp, self._index_path)

    # -- tables ---------------------------------------------------------------
    def register_table(
        self, name: str, heap_path: str, schema: dict, *,
        or_replace: bool = False,
    ) -> None:
        """Register (or, with ``or_replace=True``, overwrite) a table entry.

        A name collision is an error by default — silently replacing a table
        someone else's query reads is exactly the kind of footgun a catalog
        exists to prevent. SQL reaches this via ``INSERT OR REPLACE INTO``.
        """
        if not or_replace and name in self._index["tables"]:
            raise ValueError(
                f"catalog: table {name!r} already exists; pass "
                f"or_replace=True (SQL: INSERT OR REPLACE INTO) to overwrite"
            )
        self._index["tables"][name] = {"heap": heap_path, "schema": schema}
        self._flush()

    def has_table(self, name: str) -> bool:
        return name in self._index["tables"]

    def table(self, name: str) -> dict:
        try:
            return self._index["tables"][name]
        except KeyError:
            raise KeyError(f"catalog: unknown table {name!r}") from None

    # -- UDF accelerator artifacts ---------------------------------------------
    def register_udf(self, name: str, artifact: dict) -> None:
        validate_udf_artifact(name, artifact)
        path = os.path.join(self.root, f"udf_{name}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(artifact, f)
        os.replace(path + ".tmp", path)
        self._index["udfs"][name] = {"artifact": path}
        self._flush()

    def udf(self, name: str) -> dict:
        try:
            entry = self._index["udfs"][name]
        except KeyError:
            raise KeyError(f"catalog: unknown UDF {name!r}") from None
        with open(entry["artifact"], "rb") as f:
            artifact = pickle.load(f)
        # artifacts written before the schema check existed get validated on
        # the way out, so the executor never sees a malformed one
        validate_udf_artifact(name, artifact)
        return artifact

    # -- LM weights, beside the index -------------------------------------------
    def save_weights(self, name: str, params) -> WeightsFile:
        """Write UDF ``name``'s parameter tree (nested dicts and lists of
        tensors, on any device; dtypes and layouts kept) to
        ``udf_<name>.weights.pt``, replacing an earlier file whole."""
        rel = f"udf_{name}.weights.pt"
        path = os.path.join(self.root, rel)
        torch.save(params, path + ".tmp")
        os.replace(path + ".tmp", path)
        return WeightsFile(rel, os.path.getsize(path), _n_leaves(params))

    def load_weights(self, ref: WeightsFile, device):
        """The tree ``ref`` names, memory-mapped from its file and moved to
        ``device`` one leaf at a time."""
        tree = torch.load(os.path.join(self.root, ref.path), map_location="cpu",
                          mmap=True, weights_only=True)

        def to(node):
            if isinstance(node, dict):
                return {k: to(v) for k, v in node.items()}
            if isinstance(node, list):
                return [to(v) for v in node]
            return node.to(device)

        return to(tree)

    def udfs(self) -> list[str]:
        return sorted(self._index["udfs"])

    def tables(self) -> list[str]:
        return sorted(self._index["tables"])
