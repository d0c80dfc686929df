"""RDBMS catalog: tables + compiled UDF accelerator artifacts.

Mirrors the paper's design — 'DAnA stores accelerator metadata (Strider and
execution engine instruction schedules) in the RDBMS's catalog along with the
name of a UDF to be invoked from the query'. Artifacts are stored with pickle
(schedules, hDFGs, design points) next to a JSON index.

Copy of ``repro.db.catalog``, which it is held against; the port imports nothing of ``repro``.
"""
from __future__ import annotations

import json
import os
import pickle


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

    def udfs(self) -> list[str]:
        return sorted(self._index["udfs"])

    def tables(self) -> list[str]:
        return sorted(self._index["tables"])
