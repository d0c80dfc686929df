"""Inputs of the paged-attention parity cases, shared by
``test_torch_paged_attn.py`` (the plain version against ``repro`` on the CPU),
``test_torch_cuda.py`` and ``chip_smoke.py`` (the kernel B5 against the plain
version on the card); numpy only, so the card's machine can import it. They port the cases of ``tests/test_paged_attn_kernel.py``: head
layouts, block geometries, SWA rings cold and warm, ``max_rows`` clipping,
bf16 pools and shared blocks, plus unmapped table entries clamped to 0, G of
1, 4 and 5 and block sizes of 1, 4 and 16, and the shapes that pick each of
the kernel's bodies and tilings (head dims that fill 1, 2, 4 or 8 elements
per lane or leave lanes idle, 4 and 8 heads per CTA with idle heads, head
dims past 256, a serving shape at a context of 1,088 rows). Every pool holds
random rows everywhere, so each unread row stands for a recycled block's
stale content.
"""
import numpy as np


def make(t=5, kvh=2, g=3, dk=8, dv=8, nb_slot=4, bs=4, num_blocks=32,
         ring_width=0, seed=0, pos=None, table=None, max_rows=None,
         bf16=False, scale=0.37):
    """q, k_pool, v_pool (f32 numpy; ``bf16`` says to cast them), table,
    pos and the keyword arguments of ``paged_attention``. By default the
    table's rows are distinct permuted physical blocks (nothing is block-id
    ordered) and the positions span empty, mid-block, block-boundary and
    full coverage."""
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
    return (q, k, v, np.asarray(table, np.int32), np.asarray(pos, np.int32), kw, bf16)


def _unmapped():
    # each token maps a prefix of its row; the rest is clamped to block 0,
    # which holds another token's rows: reads through it must stay masked
    table = np.array([[3, 0, 0, 0], [5, 6, 0, 0], [7, 8, 9, 0], [1, 2, 4, 10]])
    return make(t=4, nb_slot=4, bs=4, num_blocks=12, table=table,
                pos=np.array([2, 5, 11, 15]), seed=8)


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
    # idle lanes (Dk 96, Dv 160), 8 heads per CTA, idle heads (G 12 in tiles
    # of 8), and head dims of 256 with G 8, which take the tiled body
    "g3_dk96_dv160": lambda: make(t=5, kvh=2, g=3, dk=96, dv=160, bs=16, nb_slot=3,
                                  num_blocks=24, seed=11),
    "g8_dk64": lambda: make(t=5, kvh=1, g=8, dk=64, dv=64, bs=8, nb_slot=4, num_blocks=24,
                            seed=12),
    "g12_dk128": lambda: make(t=4, kvh=1, g=12, dk=128, dv=128, bs=16, nb_slot=2,
                              num_blocks=12, seed=13, bf16=True),
    "g8_dk256": lambda: make(t=3, kvh=1, g=8, dk=256, dv=256, bs=16, nb_slot=2, num_blocks=8,
                             seed=16),
}


def test_cases_are_well_formed():
    """Every case's table names blocks of its pools and its shapes agree, so
    a failure of a parity test is the kernel's, not the case's."""
    for name, fn in CASES.items():
        q, k, v, table, pos, kw, _ = fn()
        t, kvh, g, dk = q.shape
        assert k.shape[1:] == (kw["block_size"], kvh, dk) and v.shape[:3] == k.shape[:3], name
        assert table.shape[0] == t == pos.shape[0] and table.dtype == pos.dtype == np.int32, name
        assert 0 <= table.min() and table.max() < k.shape[0] and pos.min() >= 0, name
        assert 1 <= kw["max_rows"] <= table.shape[1] * kw["block_size"], name
