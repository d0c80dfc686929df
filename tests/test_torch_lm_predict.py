"""LM PREDICT through the port's SQL surface, held against ``repro`` on the
CPU: the same token table and the same weights (``repro``'s numpy tree,
carried over by ``params_from_numpy``) through both packages' ``execute``.
Generated tokens are compared by ``assert_greedy_matches`` (equal except at a
measured near-tie); row counts, the INSERTed pages and the error messages
are compared exactly. The port's catalog keeps the weights in a file beside
its index, never in the pickled artifact, and that is checked here too."""
import os
import pickle

import jax
import numpy as np
import pytest
import torch
from repro.configs import get_reduced_config as jreduced
from repro.db.catalog import Catalog as JCatalog
from repro.db.heap import HeapFile as JHeapFile
from repro.db.heap import write_token_table as jwrite_token_table
from repro.db.query import execute as jexecute
from repro.db.query import register_lm_udf as jregister_lm_udf
from repro.models import model_zoo as jzoo

from repro_torch.configs import get_reduced_config
from repro_torch.db import Database, scoring
from repro_torch.db.catalog import Catalog, WeightsFile
from repro_torch.db.heap import HeapFile, write_token_table
from repro_torch.db.query import execute, register_lm_udf
from repro_torch.kernels.strider import ops as strider_ops
from repro_torch.models.params import leaves, params_from_numpy
from repro_torch.serve import serving
from test_torch_serve_util import CPU, assert_greedy_matches, one_cpu_thread  # noqa: F401

ARCH = "internlm2-20b"  # a GQA family, as repro's own LM PREDICT test
PAGE_BYTES = 512  # the 16 prompts take several pages
NEW = 4


@pytest.fixture(scope="module")
def models():
    """(cfg, jcfg, repro's weights, the port's copy of them)."""
    cfg, jcfg = get_reduced_config(ARCH), jreduced(ARCH)
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device=CPU)
    return cfg, jcfg, jp, tp


def _prompts(vocab):
    """repro's test prompts (seed 17), then ten more whose first token is 7
    in rows 6, 8, 10, 12 and 15, and nowhere else."""
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, vocab, size=int(n)).tolist()
               for n in rng.integers(3, 8, size=6)]
    rng = np.random.default_rng(18)
    for i in range(10):
        p = rng.integers(8, vocab, size=3 + i % 5).tolist()
        if i in (0, 2, 4, 6, 9):
            p[0] = 7
        prompts.append(p)
    return prompts


@pytest.fixture
def catalogs(tmp_path, models):
    """The port's and repro's catalogs over the same token table ``p`` and
    the same model ``lm``; and the prompts."""
    cfg, jcfg, jp, tp = models
    prompts = _prompts(cfg.vocab_size)
    cat, jcat = Catalog(str(tmp_path / "cat")), JCatalog(str(tmp_path / "jcat"))
    write_token_table(str(tmp_path / "p.heap"), prompts, page_bytes=PAGE_BYTES)
    jwrite_token_table(str(tmp_path / "jp.heap"), prompts, page_bytes=PAGE_BYTES)
    cat.register_table("p", str(tmp_path / "p.heap"), {"kind": "tokens"})
    jcat.register_table("p", str(tmp_path / "jp.heap"), {"kind": "tokens"})
    register_lm_udf(cat, "lm", cfg, tp)
    jregister_lm_udf(jcat, "lm", jcfg, jp)
    return cat, jcat, prompts


def _both(catalogs, sql, **kw):
    cat, jcat, _ = catalogs
    return execute(sql, cat, device=CPU, **kw), jexecute(sql, jcat, **kw)


def _assert_tokens_match(models, prompts, got, want):
    cfg, jcfg, jp, tp = models
    assert len(got) == len(want)
    for q, g, w in zip(prompts, got, want):
        assert_greedy_matches(cfg, tp, jcfg, jp, q, g, w)


def test_lm_predict_token_exact_gqa(models, catalogs):
    """repro's test, through both packages: a WHERE on ``label`` (the prompt
    length); the port's tokens equal repro's and its own generate_greedy's."""
    cfg, _, _, tp = models
    prompts = catalogs[2]
    got, want = _both(catalogs, "SELECT * FROM dana.predict('lm', 'p') WHERE label >= 5;",
                      max_new_tokens=NEW)
    kept = [p for p in prompts if len(p) >= 5]
    assert got.n_rows == want.n_rows == len(kept) > 0
    assert got.rows_filtered == want.rows_filtered == len(prompts) - len(kept)
    assert got.rows_scanned == want.rows_scanned == len(prompts)
    assert (got.verb, got.schema, got.device_syncs) == ("PREDICT", ("prediction",), 1)
    assert got.pushdown == scoring.PushdownStats(**vars(want.pushdown))
    _assert_tokens_match(models, kept, got.predictions, want.predictions)
    direct = serving.generate_greedy(cfg, tp, kept, NEW, device=CPU)
    assert got.predictions == direct
    assert got.serve_metrics is not None and want.serve_metrics is not None
    assert got.serve_metrics.tokens_generated == want.serve_metrics.tokens_generated


@pytest.mark.parametrize("chunk_pages", [None, 1])
def test_where_on_a_token_column(models, catalogs, chunk_pages):
    """``c0 = 7`` compares token ids. Stored as f32 they are denormals, so a
    compare of the decoded f32 values with 7.0 would keep nothing; the
    port's keep set and tokens equal repro's, over one chunk and over one
    chunk a page."""
    prompts = catalogs[2]
    sql = "SELECT * FROM dana.predict('lm', 'p') WHERE c0 = 7 AND label >= 5;"
    got, want = _both(catalogs, sql, max_new_tokens=NEW, chunk_pages=chunk_pages)
    kept = [p for p in prompts if p[0] == 7 and len(p) >= 5]
    assert got.n_rows == want.n_rows == len(kept) == 3
    assert got.rows_filtered == want.rows_filtered == len(prompts) - 3
    _assert_tokens_match(models, kept, got.predictions, want.predictions)
    heap = HeapFile(catalogs[0].table("p")["heap"])
    assert heap.n_pages > 1
    feats, _, _ = strider_ops.decode_pages(strider_ops.pages_tensor(heap.read_all()),
                                           heap.layout)
    assert not bool((feats[..., 0] == 7.0).any())


def test_insert_into_writes_repro_s_pages(models, catalogs):
    """INSERT INTO stores the generated tokens as a token table with repro's
    pages byte for byte and repro's schema; a zero-row result registers
    nothing in either package; a taken name is refused with repro's words."""
    cat, jcat, _ = catalogs
    got, want = _both(catalogs,
                      "INSERT INTO out SELECT * FROM dana.predict('lm', 'p') WHERE label >= 5;",
                      max_new_tokens=NEW)
    assert got.predictions == want.predictions
    heap, jheap = HeapFile(cat.table("out")["heap"]), JHeapFile(jcat.table("out")["heap"])
    assert heap.read_all().tobytes() == jheap.read_all().tobytes()
    assert (heap.n_tuples, heap.layout.n_features, heap.layout.page_bytes) == \
        (jheap.n_tuples, jheap.layout.n_features, jheap.layout.page_bytes)
    assert cat.table("out")["schema"] == jcat.table("out")["schema"] == \
        {"n_features": NEW, "kind": "tokens"}

    got, want = _both(catalogs, "INSERT INTO none SELECT * FROM dana.predict('lm', 'p') "
                                "WHERE label > 100;", max_new_tokens=NEW)
    assert got.n_rows == want.n_rows == 0 and got.predictions == want.predictions == []
    assert got.serve_metrics is None and want.serve_metrics is None
    assert not cat.has_table("none") and not jcat.has_table("none")
    assert cat.tables() == jcat.tables() == ["out", "p"]

    sql = "INSERT INTO out SELECT * FROM dana.predict('lm', 'p') WHERE label >= 5;"
    with pytest.raises(ValueError) as e:
        execute(sql, cat, max_new_tokens=NEW, device=CPU)
    with pytest.raises(ValueError) as je:
        jexecute(sql, jcat, max_new_tokens=NEW)
    assert str(e.value) == str(je.value)
    replaced = execute(sql.replace("INSERT", "INSERT OR REPLACE"), cat,
                       max_new_tokens=2, device=CPU)
    assert HeapFile(cat.table("out")["heap"]).layout.n_features == 2 == \
        len(replaced.predictions[0])


@pytest.mark.parametrize("sql", [
    "SELECT COUNT(*) FROM dana.predict('lm', 'p');",
    "SELECT c0 FROM dana.predict('lm', 'p') WHERE label >= 5;",
], ids=["aggregates", "column_list"])
def test_rejections_match_repro(catalogs, sql):
    cat, jcat, _ = catalogs
    with pytest.raises(ValueError) as e:
        execute(sql, cat, device=CPU)
    with pytest.raises(ValueError) as je:
        jexecute(sql, jcat)
    assert str(e.value) == str(je.value)


def test_the_artifact_keeps_the_weights_out_of_the_pickle(models, catalogs, monkeypatch):
    """The pickle is small and holds no tensor; the weights file beside the
    index round-trips bit for bit, memory-mapped."""
    cfg, _, _, tp = models
    cat = catalogs[0]
    path = cat._index["udfs"]["lm"]["artifact"]
    raw = open(path, "rb").read()
    assert len(raw) < 64 * 1024
    assert b"_rebuild_tensor" not in raw and b"numpy" not in raw
    art = pickle.loads(raw)
    ref = art["params"]
    assert isinstance(ref, WeightsFile) and art["kind"] == "lm" and art["cfg"] == cfg
    assert ref.path == "udf_lm.weights.pt" and not os.path.isabs(ref.path)
    assert ref.nbytes == os.path.getsize(os.path.join(cat.root, ref.path))
    assert ref.n_leaves == len(list(leaves(tp)))

    calls = []
    real = torch.load
    monkeypatch.setattr(torch, "load", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    back = cat.load_weights(ref, CPU)
    assert calls == [{"map_location": "cpu", "mmap": True, "weights_only": True}]
    pairs = list(zip(leaves(back), leaves(tp)))
    assert len(pairs) == ref.n_leaves
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape and a.stride() == b.stride()
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_re_registering_replaces_the_weights_file(models, catalogs):
    cfg, jcfg, _, tp = models
    cat = catalogs[0]
    jp1, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(1))
    tp1 = params_from_numpy(cfg, jax.tree.map(np.asarray, jp1), device=CPU)
    first = cat.udf("lm")["params"]
    register_lm_udf(cat, "lm", cfg, tp1)
    ref = cat.udf("lm")["params"]
    assert ref == first  # same file name, size and leaf count: the file was replaced
    assert sorted(f for f in os.listdir(cat.root) if "weights" in f) == ["udf_lm.weights.pt"]
    for a, b in zip(leaves(cat.load_weights(ref, CPU)), leaves(tp1)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    kept = [p for p in catalogs[2] if len(p) >= 6]
    res = execute("SELECT * FROM dana.predict('lm', 'p') WHERE label >= 6;", cat,
                  max_new_tokens=NEW, device=CPU)
    assert res.predictions == serving.generate_greedy(cfg, tp1, kept, NEW, device=CPU)
    assert res.predictions != serving.generate_greedy(cfg, tp, kept, NEW, device=CPU)


def test_a_reopened_catalog_runs_the_predict(catalogs):
    cat = catalogs[0]
    sql = "SELECT * FROM dana.predict('lm', 'p') WHERE label >= 6;"
    want = execute(sql, cat, max_new_tokens=NEW, device=CPU)
    got = execute(sql, Catalog(cat.root), max_new_tokens=NEW, device=CPU)
    assert got.predictions == want.predictions and got.n_rows == want.n_rows > 0


@pytest.mark.parametrize("params", ["none", "tree"])
def test_params_that_name_no_weights_file_are_refused(models, catalogs, params):
    """An LM artifact whose params are not a WeightsFile (None, or a tree of
    tensors pickled whole) is refused, naming register_lm_udf."""
    cfg, _, _, tp = models
    cat = catalogs[0]
    cat.register_udf("raw", {"kind": "lm", "cfg": cfg, "params": None if params == "none" else tp})
    with pytest.raises(ValueError, match="register_lm_udf"):
        execute("SELECT * FROM dana.predict('raw', 'p');", cat, device=CPU)


def test_session_sql_reaches_the_server(models, catalogs, monkeypatch):
    """``Session.sql``'s max_new_tokens= and batch_slots= reach the serving
    session; its tokens are those of ``execute`` with the default slots."""
    cat = catalogs[0]
    seen = []
    real = serving.score_tokens

    def spy(cfg, params, prompts, **kw):
        seen.append((len(prompts), kw))
        return real(cfg, params, prompts, **kw)

    monkeypatch.setattr(serving, "score_tokens", spy)
    sql = "SELECT * FROM dana.predict('lm', 'p') WHERE label >= 5;"
    sess = Database(cat, page_bytes=PAGE_BYTES, device=CPU).connect()
    res = sess.sql(sql, max_new_tokens=3, batch_slots=2)
    assert seen == [(res.n_rows, {"max_new_tokens": 3, "batch_slots": 2,
                                  "device": torch.device(CPU)})]
    assert all(len(g) == 3 for g in res.predictions)
    assert res.predictions == execute(sql, cat, max_new_tokens=3, device=CPU).predictions
    sess.close()


def test_predict_scan_refuses_an_lm_udf(catalogs):
    """The GLM/LRMF scan (the concurrent executor's unit) points an LM UDF to
    execute_predict; the executor refuses it at submit."""
    from repro_torch.db.query import parse

    with pytest.raises(ValueError, match="execute_predict"):
        scoring.PredictScan(parse("SELECT * FROM dana.predict('lm', 'p');"), catalogs[0],
                            device=CPU)
