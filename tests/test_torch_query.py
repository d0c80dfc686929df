"""The port's SQL surface (repro_torch.db.query, repro_torch.db.catalog)
against repro's: every SQL string of tests/test_db_query.py and
tests/test_query_engine.py, plus a few more, parses to the same statement
tree (compared node by node, class names included) or is rejected with the
same message; WHERE trees keep the same rows on numpy and torch columns; the
catalogs agree on collisions, unknown names and artifact checks."""
import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.db import catalog as jcatalog
from repro.db import query as jquery
from repro_torch.algorithms import linear_regression
from repro_torch.db import catalog, query

TESTS = os.path.dirname(os.path.abspath(__file__))


def _sql_strings():
    """The SQL literals of the reference's query tests, in file order."""
    out = []
    for name in ("test_db_query.py", "test_query_engine.py"):
        with open(os.path.join(TESTS, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and node.value.lstrip().upper().startswith(("SELECT", "INSERT"))
                    and node.value not in out):
                out.append(node.value)
    return out


EXTRA = [
    "select * from dana.predict('u','t') where c1 <> 2 and c2 = 3;",
    "SELECT c0 FROM dana.predict('u', 't') WHERE NOT NOT c1 > -1e-3",
    "SELECT c0, label FROM dana.predict('u', 't') WHERE c1 != .5 OR c2 >= +2 OR c3 < 1E2;",
    "SELECT SUM(prediction), COUNT(c1), AVG(label) FROM dana.predict('u', 't');",
    "INSERT OR REPLACE INTO x SELECT * FROM dana.predict('u', 't');",
    "INSERT OR INTO x SELECT * FROM dana.predict('u', 't');",
    "INSERT INTO x SELECT * FROM dana.u('t');",
    "SELECT * FROM dana.u('t') WHERE c1 > 0;",
    "SELECT c0 FROM dana.u('t');",
    "SELECT * FROM dana.u('t', 'v');",
    "SELECT * FROM dana.predict('u', 't') extra",
    "SELECT SUM(*) FROM dana.predict('u', 't');",
    "SELECT AVG(bogus) FROM dana.predict('u', 't');",
    "SELECT c0 FROM dana.predict('u', 't') WHERE prediction > 0;",
    "SELECT c0 FROM dana.predict('u', 't') WHERE c1 > 0 AND;",
    "SELECT c0 FROM dana.predict('u', 't') WHERE label > 'x';",
    "UPDATE t SET c0 = 1;",
    "",
]
SQL = _sql_strings() + EXTRA


def walk(node):
    """A statement tree as nested tuples of class names and fields:
    ``dataclasses.asdict`` would lose the difference between And and Or."""
    if dataclasses.is_dataclass(node):
        return (type(node).__name__,) + tuple(
            (f.name, walk(getattr(node, f.name))) for f in dataclasses.fields(node))
    if isinstance(node, tuple):
        return tuple(walk(x) for x in node)
    return node


def test_reference_sql_was_collected():
    assert len(SQL) > 50 and any(s.startswith("INSERT") for s in SQL)


@pytest.mark.parametrize("i", range(len(SQL)), ids=[f"sql{i}" for i in range(len(SQL))])
def test_parse_matches_repro(i):
    sql = SQL[i]
    try:
        want = jquery.parse(sql)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            query.parse(sql)
        assert str(got.value) == str(e)
        return
    got = query.parse(sql)
    assert walk(got) == walk(want)


WHERE = [
    "c1 > 0.0",
    "c1 > 0.1",
    "c1 == 0.1",
    "NOT c1 > 0.5",
    "c2 > 0.0 OR c3 <= -0.5",
    "(c1 > 0.0 AND c2 <= 0.5) OR NOT (label < 0.0)",
    "NOT c1 > 0.0 AND c2 < 1.0 OR c3 == 2.0",
    "c0 != 0.25 AND (label >= 1 OR label = -1)",
]


@pytest.mark.parametrize("where", WHERE)
def test_where_trees_keep_the_same_rows(where):
    sql = f"SELECT c0 FROM dana.predict('u', 't') WHERE {where};"
    tree, jtree = query.parse(sql).where, jquery.parse(sql).where
    assert tree.columns() == jtree.columns()
    rng = np.random.default_rng(3)
    cols = {f"c{i}": np.round(rng.normal(0, 1, 500), 1).astype(np.float32) for i in range(4)}
    cols["c1"][::9] = np.float32(0.1)
    cols["c0"][::11] = np.float32(0.25)
    cols["label"] = rng.integers(-1, 2, 500).astype(np.float32)
    want = np.asarray(jtree.evaluate(lambda c: cols[c]))
    on_numpy = tree.evaluate(lambda c: cols[c])
    on_torch = tree.evaluate(lambda c: torch.from_numpy(cols[c]))
    assert on_torch.dtype == torch.bool
    np.testing.assert_array_equal(on_numpy, want)
    np.testing.assert_array_equal(on_torch.numpy(), want)


def test_node_and_aggregate_rejections_match():
    cases = [
        (lambda m: m.Predicate("c1", "~", 1.0),),
        (lambda m: m.Predicate("prediction", ">", 1.0),),
        (lambda m: m.And((m.Predicate("c1", ">", 0.0),)),),
        (lambda m: m.Or(()),),
        (lambda m: m.Aggregate("MAX", "c1"),),
        (lambda m: m.Aggregate("SUM", None),),
        (lambda m: m.Aggregate("AVG", "bogus"),),
    ]
    for (make,) in cases:
        with pytest.raises(ValueError) as got:
            make(query)
        with pytest.raises(ValueError) as want:
            make(jquery)
        assert str(got.value) == str(want.value)
    assert query.Aggregate("COUNT", None).label == jquery.Aggregate("COUNT", None).label
    assert query.Aggregate("AVG", "prediction").label == "avg(prediction)"


def test_result_and_statement_fields_match():
    fields = [f.name for f in dataclasses.fields(query.QueryResult)]
    jfields = [f.name for f in dataclasses.fields(jquery.QueryResult)]
    assert fields == jfields
    assert ([f.name for f in dataclasses.fields(query.Statement)]
            == [f.name for f in dataclasses.fields(jquery.Statement)])


# ---------------------------------- catalog ----------------------------------
def _catalogs(tmp_path):
    return catalog.Catalog(str(tmp_path / "cat")), jcatalog.Catalog(str(tmp_path / "jcat"))


def _same_error(exc, fn, jfn):
    with pytest.raises(exc) as got:
        fn()
    with pytest.raises(exc) as want:
        jfn()
    assert str(got.value) == str(want.value)


def test_catalog_collisions_and_unknown_names(tmp_path):
    cat, jcat = _catalogs(tmp_path)
    for c in (cat, jcat):
        c.register_table("t", "/x.heap", {"n_features": 3})
    _same_error(ValueError, lambda: cat.register_table("t", "/y.heap", {}),
                lambda: jcat.register_table("t", "/y.heap", {}))
    for c in (cat, jcat):
        c.register_table("t", "/y.heap", {"n_features": 4}, or_replace=True)
        assert c.table("t") == {"heap": "/y.heap", "schema": {"n_features": 4}}
        assert c.has_table("t") and not c.has_table("u")
    _same_error(KeyError, lambda: cat.table("nope"), lambda: jcat.table("nope"))
    _same_error(KeyError, lambda: cat.udf("nope"), lambda: jcat.udf("nope"))
    assert cat.tables() == jcat.tables() == ["t"]
    # the index survives a reopen
    assert catalog.Catalog(cat.root).table("t") == cat.table("t")


@pytest.mark.parametrize("artifact", [
    [], {"hdfg": 1}, {"kind": "lm", "cfg": 1}, {"kind": "lm", "params": 1}, {},
], ids=["not_a_dict", "no_partition", "lm_no_params", "lm_no_cfg", "empty"])
def test_artifact_checks_match(tmp_path, artifact):
    cat, jcat = _catalogs(tmp_path)
    _same_error(ValueError, lambda: cat.register_udf("u", artifact),
                lambda: jcat.register_udf("u", artifact))
    assert cat.udfs() == []


def test_artifacts_pickle_the_ports_classes(tmp_path):
    """A port catalog's artifact unpickles into the port's own classes: the
    two packages never share a catalog."""
    cat, _ = _catalogs(tmp_path)
    from repro_torch.db.page import PageLayout

    art = query.register_udf_from_trace(
        cat, "lin", lambda: linear_regression(4, merge_coef=8),
        layout=PageLayout(n_features=4, page_bytes=1024))
    back = catalog.Catalog(cat.root).udf("lin")
    for key in ("hdfg", "partition", "layout", "design_point"):
        assert type(back[key]).__module__.startswith("repro_torch."), key
    np.testing.assert_array_equal(back["strider_program"], art["strider_program"])
    assert cat.udfs() == ["lin"]
    query.set_udf_model(cat, "lin", [np.arange(4, dtype=np.float64)])
    model = cat.udf("lin")["model"]
    assert model[0].dtype == np.float32 and model[0].tolist() == [0, 1, 2, 3]
