"""Inputs of the paged-attention parity cases, shared by
``test_torch_paged_attn.py`` (the plain version against ``repro`` on the CPU),
``test_torch_cuda.py`` and ``chip_smoke.py`` (the kernel B5 against the plain
version on the card); numpy only, so the card's machine can import it. They
port the cases of ``tests/test_paged_attn_kernel.py``: head layouts, block
geometries, SWA rings cold and warm, ``max_rows`` clipping, bf16 pools and
shared blocks, plus unmapped table entries clamped to 0, G of 1, 4 and 5 and
block sizes of 1, 4 and 16, and the shapes that pick each of the kernel's
bodies and layouts (Dv in 1 to 4 groups of 64 columns or leaving columns
idle, rows of 8 query heads or fewer and of 12, f32 and tensor-core scores,
head dims of 256 and past it, a serving shape at a context of 1,088 rows,
hymba's sliding-window heads on a ring that has wrapped, olmoe's 16 heads
of 128 at G 1),
and runs: rows that share one table row, given to the kernel as (first row,
count) pairs so that it reads their context once (prefill runs of 16 beside
decode rows, mixed run lengths, runs across and up to the kernel's split
boundary of ``SPLIT_ROWS`` context rows, ``max_rows`` clipping and SWA
rings within a run, runs of 8 query rows or fewer and of more than 64).
Every pool holds random rows everywhere, so each unread row stands for a
recycled block's stale content. ``LATENT_CASES`` hold the same patterns at
the absorbed-MLA layout of the kernel's latent entry (q (T, H, Dc + Dr), the
pools c and kr; K = [c ; kr], V = c), with runs on both sides of its context
splits of ``LATENT_SPLIT_ROWS``, and the shapes of minicpm3-4b (H 40, Dc 256,
Dr 32) and deepseek-v3 (H 128, Dc 512, Dr 64).
"""
import numpy as np

# context rows per CTA of the kernel's split body (kSplitRows in
# src/repro_torch/csrc/paged_attn.cu): the split cases sit on its boundary
SPLIT_ROWS = 128
# the context splits the latent entry may take (LATENT_SPLITS in
# src/repro_torch/kernels/paged_attn/kernel.py)
LATENT_SPLIT_ROWS = (32, 64, 128)


def make(t=5, kvh=2, g=3, dk=8, dv=8, nb_slot=4, bs=4, num_blocks=32,
         ring_width=0, seed=0, pos=None, table=None, max_rows=None,
         bf16=False, scale=0.37, runs=None):
    """q, k_pool, v_pool (f32 numpy; ``bf16`` says to cast them), table,
    pos, the keyword arguments of ``paged_attention``, the bf16 flag and the
    runs ((R, 2) int32 (first row, count); by default one row each). By
    default the table's rows are distinct permuted physical blocks (nothing
    is block-id ordered) and the positions span empty, mid-block,
    block-boundary and full coverage."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (t, kvh, g, dk)).astype(np.float32)
    k = rng.normal(0, 1, (num_blocks, bs, kvh, dk)).astype(np.float32)
    v = rng.normal(0, 1, (num_blocks, bs, kvh, dv)).astype(np.float32)
    if table is None:
        table = rng.permutation(num_blocks)[: t * nb_slot].reshape(t, nb_slot)
    span = ring_width if ring_width else nb_slot * bs
    if pos is None:
        pos = (np.minimum(np.array([0, 1, bs - 1, bs, span - 1] * (t // 5 + 1))[:t],
                          span - 1) if span > 1 else np.zeros(t))
    if max_rows is None:
        max_rows = nb_slot * bs
    kw = dict(block_size=bs, ring_width=ring_width, max_rows=max_rows, scale=scale)
    if runs is None:
        runs = [(i, 1) for i in range(t)]
    return (q, k, v, np.asarray(table, np.int32), np.asarray(pos, np.int32), kw, bf16,
            np.asarray(runs, np.int32).reshape(-1, 2))


def _runs_case(lengths, positions, t_extra_pos=(), nb_slot=8, bs=4, num_blocks=None,
               seed=0, **kw):
    """Runs of ``lengths`` rows (run j at the consecutive positions from
    ``positions[j]``, all its rows on one table row), then one-row runs at
    ``t_extra_pos``, each on a table row of its own; the table rows are
    distinct permuted blocks."""
    n_rows = len(lengths) + len(t_extra_pos)
    if num_blocks is None:
        num_blocks = n_rows * nb_slot + 8
    blocks = np.random.default_rng(seed + 100).permutation(num_blocks)
    own = blocks[: n_rows * nb_slot].reshape(n_rows, nb_slot)
    table, pos, runs = [], [], []
    for j, n in enumerate(lengths):
        runs.append((len(pos), n))
        table += [own[j]] * n
        pos += list(range(positions[j], positions[j] + n))
    for j, p in enumerate(t_extra_pos):
        runs.append((len(pos), 1))
        table.append(own[len(lengths) + j])
        pos.append(p)
    return make(t=len(pos), nb_slot=nb_slot, bs=bs, num_blocks=num_blocks, seed=seed,
                table=np.array(table), pos=np.array(pos), runs=runs, **kw)


def _unmapped_at(**kw):
    # each token maps a prefix of its row; the rest is clamped to block 0,
    # which holds another token's rows: reads through it must stay masked
    table = np.array([[3, 0, 0, 0], [5, 6, 0, 0], [7, 8, 9, 0], [1, 2, 4, 10]])
    return make(t=4, nb_slot=4, bs=4, num_blocks=12, table=table,
                pos=np.array([2, 5, 11, 15]), seed=8, **kw)


def _unmapped():
    return _unmapped_at()


CASES = {
    # head layouts: GQA, MLA-as-MQA (Dk != Dv), MHA-as-GQA
    "gqa": lambda: make(kvh=2, g=3, dk=8, dv=8),
    "mqa_dk_ne_dv": lambda: make(kvh=1, g=6, dk=24, dv=16),
    "g1": lambda: make(kvh=4, g=1, dk=8, dv=8),
    "g4": lambda: make(kvh=2, g=4, dk=16, dv=16, seed=1),
    "g5_dk_ne_dv": lambda: make(kvh=1, g=5, dk=16, dv=12, seed=9),
    # block geometries: odd sizes, single-block tables, partial trailing blocks
    "bs1": lambda: make(t=6, bs=1, nb_slot=3, num_blocks=32, seed=2),
    "bs3": lambda: make(t=6, bs=3, nb_slot=5, num_blocks=32, seed=2),
    "bs4_one_block": lambda: make(t=6, bs=4, nb_slot=1, num_blocks=32, seed=2),
    "bs5": lambda: make(t=6, bs=5, nb_slot=4, num_blocks=32, seed=2),
    "bs16": lambda: make(t=5, bs=16, nb_slot=3, num_blocks=16, kvh=2, g=4, dk=32,
                         dv=32, seed=10),
    # SWA rings straddling the warm boundary, far past it included
    "ring4": lambda: make(t=6, bs=2, nb_slot=2, ring_width=4, seed=3,
                          pos=np.array([0, 1, 3, 4, 11, 3])),
    "ring6": lambda: make(t=6, bs=2, nb_slot=3, ring_width=6, seed=3,
                          pos=np.array([0, 1, 5, 6, 13, 3])),
    # rows past max_rows are dead even when mapped and pos points past them
    "max_rows": lambda: make(t=4, bs=4, nb_slot=3, seed=4, max_rows=10,
                             pos=np.array([9, 10, 11, 11])),
    "bf16": lambda: make(seed=5, bf16=True),
    # several tokens of one slot share a table row (the serving layout)
    "shared_blocks": lambda: make(t=6, seed=6, table=np.tile([[7, 3, 11, 0]], (6, 1)),
                                  pos=np.array([0, 3, 4, 7, 12, 15])),
    "unmapped_clamped": _unmapped,
    # the serving shapes: mistral-nemo's heads, a long context over 70 blocks
    "gqa_dk128": lambda: make(t=6, kvh=8, g=4, dk=128, dv=128, bs=16, nb_slot=6,
                              num_blocks=48, seed=14, bf16=True, scale=128 ** -0.5),
    "long_context": lambda: make(t=3, kvh=2, g=4, dk=128, dv=128, bs=16, nb_slot=70,
                                 num_blocks=256, seed=15, bf16=True, scale=128 ** -0.5,
                                 pos=np.array([1087, 600, 33])),
    # idle columns (Dk 96, Dv 160), rows of 8 heads (one warp each) and of 12
    # (the wide layout, tensor-core scores in bf16), head dims of 256
    "g3_dk96_dv160": lambda: make(t=5, kvh=2, g=3, dk=96, dv=160, bs=16, nb_slot=3,
                                  num_blocks=24, seed=11),
    "g8_dk64": lambda: make(t=5, kvh=1, g=8, dk=64, dv=64, bs=8, nb_slot=4, num_blocks=24,
                            seed=12),
    "g12_dk128": lambda: make(t=4, kvh=1, g=12, dk=128, dv=128, bs=16, nb_slot=2,
                              num_blocks=12, seed=13, bf16=True),
    "g8_dk256": lambda: make(t=3, kvh=1, g=8, dk=256, dv=256, bs=16, nb_slot=2, num_blocks=8,
                             seed=16),
    # runs: a slot's 16 prefill rows over a 70-block context beside decode
    # rows (the last row of the table, mid-context, one block)
    "run16_prefill": lambda: _runs_case([16], [1000], (1119, 500, 7), nb_slot=70, bs=16,
                                        kvh=2, g=4, dk=128, dv=128, seed=20,
                                        scale=128 ** -0.5),
    # run lengths 1, 3, 5 and 16 in one call, contexts on both sides of a split
    "runs_mixed": lambda: _runs_case([1, 3, 5, 16], [70, 10, 120, 140], nb_slot=40,
                                     kvh=2, g=3, dk=32, dv=32, seed=21),
    # a run across the split boundary (its first 8 rows end inside split 0),
    # runs that end exactly on it (rows 0..127) and on the next (0..255), and
    # single rows whose context is 128 and 129 rows
    "runs_split_edges": lambda: _runs_case(
        [16, 16, 16], [120, SPLIT_ROWS - 16, 2 * SPLIT_ROWS - 16],
        (SPLIT_ROWS - 1, SPLIT_ROWS), nb_slot=40, bs=8, kvh=1, g=4, dk=16, dv=16,
        seed=22),
    # max_rows clips a run's later rows to one last row (129), past the split
    "runs_max_rows": lambda: _runs_case([16, 4], [120, 126], (140,), nb_slot=10, bs=16,
                                        max_rows=SPLIT_ROWS + 2, kvh=2, g=2, dk=24, dv=16,
                                        seed=23),
    # SWA rings: a run that warms up within the call (ring6) and one that
    # wraps (ring4), beside cold and warm single rows
    "runs_ring6": lambda: _runs_case([6], [3], (0, 13), nb_slot=3, bs=2, ring_width=6,
                                     seed=24),
    "runs_ring4": lambda: _runs_case([4, 2], [2, 9], (1,), nb_slot=2, bs=2, ring_width=4,
                                     seed=25),
    # bf16 at mistral-nemo's heads: a 16-row prefill run past two splits, a
    # 5-row tail, decode rows, and 3 padding rows (position 0, one row each)
    "runs_gqa_dk128_bf16": lambda: _runs_case(
        [16, 5], [600, 300], (1087, 130, 127, 0, 0, 0, 0), nb_slot=68, bs=16, kvh=8, g=4,
        dk=128, dv=128, seed=26, bf16=True, scale=128 ** -0.5),
    # the kernel's two layouts of a run's query rows: 2 tokens x G 4 (8 rows,
    # a warp each), 3 tokens (12), and 20 tokens (80 rows: two passes of 64)
    "runs_layouts": lambda: _runs_case([2, 3, 20], [40, 7, 100], (5,), nb_slot=20, bs=8,
                                       kvh=1, g=4, dk=32, dv=32, seed=27),
    # bf16 runs of 2 and 4 tokens x G 4 (8 query rows: a warp each; 16 and
    # 20 rows: the tensor cores) beside a decode row
    "runs_small_bf16": lambda: _runs_case([2, 4, 5], [300, 17, 129], (200,), nb_slot=20,
                                          bs=16, kvh=2, g=4, dk=128, dv=128, seed=28,
                                          bf16=True, scale=128 ** -0.5),
    # hymba-1.5b's sliding-window call (KVH 5, G 5, D 64, bf16, blocks of 16)
    # on a CPU-sized ring of 64 rows: positions cold, at the wrap and far past
    # it, one row per slot as chunked stepping calls it
    "hymba_ring": lambda: make(t=8, kvh=5, g=5, dk=64, dv=64, bs=16, nb_slot=4,
                               num_blocks=40, ring_width=64, seed=29, bf16=True,
                               scale=64 ** -0.5, pos=np.array([0, 17, 63, 64, 65, 100, 1087,
                                                               1040])),
    # olmoe-1b-7b's call (KVH 16, G 1, D 128, bf16, blocks of 16): one row
    # per slot as chunked stepping calls it, contexts from one row to 1,088
    "olmoe_g1": lambda: make(t=6, kvh=16, g=1, dk=128, dv=128, bs=16, nb_slot=68,
                             num_blocks=420, seed=30, bf16=True, scale=128 ** -0.5,
                             pos=np.array([0, 15, 16, 500, 1040, 1087])),
    # the shared_blocks case with its six rows declared one run
    "shared_blocks_run": lambda: make(t=6, seed=6, table=np.tile([[7, 3, 11, 0]], (6, 1)),
                                      pos=np.array([0, 3, 4, 7, 12, 15]), runs=[(0, 6)]),
}


def latent(case, dc):
    """A one-kv-head case at the latent layout: q (T, H, Dc + Dr), c_pool
    (NB, bs, Dc) the K pool's first Dc columns and kr_pool (NB, bs, Dr) the
    rest (V is c, so the case's own V pool goes unused); the keyword
    arguments without a ring. Returns q, c_pool, kr_pool, table, pos, kw,
    the bf16 flag and the runs."""
    q, k, _, table, pos, kw, bf16, runs = case
    assert q.shape[1] == 1 and not kw["ring_width"]
    kw = {n: v for n, v in kw.items() if n != "ring_width"}
    return (q[:, 0], np.ascontiguousarray(k[:, :, 0, :dc]),
            np.ascontiguousarray(k[:, :, 0, dc:]), table, pos, kw, bf16, runs)


def _latent(dc, dr, g, fn=make, **kw):
    return latent(fn(kvh=1, g=g, dk=dc + dr, dv=dc, bf16=True, **kw), dc)


LATENT_CASES = {
    # recycled (permuted) blocks, positions on and inside block edges
    "recycled": lambda: _latent(32, 16, 4, seed=30),
    # a partial last block of 5-row blocks
    "bs5_partial": lambda: _latent(32, 16, 3, t=6, bs=5, nb_slot=4, seed=31),
    # rows past max_rows are dead even when mapped and pos points past them
    "max_rows": lambda: _latent(32, 16, 3, t=4, bs=4, nb_slot=3, seed=32, max_rows=10,
                                pos=np.array([9, 10, 11, 11])),
    # unmapped entries clamped to block 0, which holds another token's rows
    "unmapped": lambda: latent(_unmapped_at(kvh=1, g=2, dk=48, dv=32, bf16=True), 32),
    # runs across and up to the 32-, 64- and 128-row splits, and single rows
    # whose contexts end on either side of them
    "runs_split_edges": lambda: _latent(
        32, 16, 4, _runs_case, lengths=[16, 16, 4, 16], positions=[20, 48, 126, 100],
        t_extra_pos=(31, 32, 63, 64, 65, 129), nb_slot=20, bs=8, seed=33),
    # max_rows clips a run's later rows to one last row past a split
    "runs_max_rows": lambda: _latent(32, 16, 3, _runs_case, lengths=[16, 4],
                                     positions=[120, 126], t_extra_pos=(140,), nb_slot=10,
                                     bs=16, max_rows=130, seed=34),
    # the runs declared one (shared_blocks_run's layout)
    "shared_blocks_run": lambda: _latent(32, 16, 4, t=6, seed=35,
                                         table=np.tile([[7, 3, 11, 0]], (6, 1)),
                                         pos=np.array([0, 3, 4, 7, 12, 15]), runs=[(0, 6)]),
    # minicpm3-4b's latent call: a 16-token prefill run past several splits,
    # a 5-token tail, decode rows and a padding row
    "minicpm3": lambda: _latent(256, 32, 40, _runs_case, lengths=[16, 5],
                                positions=[600, 300], t_extra_pos=(1087, 130, 64, 0),
                                nb_slot=68, bs=16, seed=36, scale=96 ** -0.5),
    # its decode-only step: 8 slots, one row each
    "minicpm3_decode": lambda: _latent(256, 32, 40, _runs_case, lengths=[], positions=[],
                                       t_extra_pos=(700, 650, 680, 500, 1000, 900, 3, 40),
                                       nb_slot=68, bs=16, seed=37, scale=96 ** -0.5),
    # deepseek-v3's latent (Dc 512, Dr 64, 128 heads)
    "deepseek": lambda: _latent(512, 64, 128, _runs_case, lengths=[6], positions=[200],
                                t_extra_pos=(300, 33), nb_slot=24, bs=16, seed=38,
                                scale=192 ** -0.5),
}


def test_cases_are_well_formed():
    """Every case's table names blocks of its pools and its shapes agree, so
    a failure of a parity test is the kernel's, not the case's."""
    for name, fn in CASES.items():
        q, k, v, table, pos, kw, _, runs = fn()
        t, kvh, g, dk = q.shape
        assert k.shape[1:] == (kw["block_size"], kvh, dk) and v.shape[:3] == k.shape[:3], name
        assert table.shape[0] == t == pos.shape[0] and table.dtype == pos.dtype == np.int32, name
        assert 0 <= table.min() and table.max() < k.shape[0] and pos.min() >= 0, name
        assert 1 <= kw["max_rows"] <= table.shape[1] * kw["block_size"], name
        # the runs cover the rows in order, once each, and the rows of a run
        # share one table row
        assert runs.dtype == np.int32 and runs.shape[1] == 2 and runs[:, 1].min() >= 1, name
        assert runs[0, 0] == 0 and runs[-1].sum() == t, name
        assert np.array_equal(runs[1:, 0], runs[:-1].sum(1)), name
        for first, n in runs:
            assert (table[first:first + n] == table[first]).all(), name

    for name, fn in LATENT_CASES.items():
        q, c, kr, table, pos, kw, bf16, runs = fn()
        assert bf16 and "ring_width" not in kw, name
        assert c.shape[:2] == kr.shape[:2] == (c.shape[0], kw["block_size"]), name
        assert q.shape[2] == c.shape[2] + kr.shape[2] and table.shape[0] == q.shape[0], name
        assert 0 <= table.min() and table.max() < c.shape[0], name
        assert runs[0, 0] == 0 and runs[-1].sum() == q.shape[0], name
        for first, n in runs:
            assert (table[first:first + n] == table[first]).all(), name
