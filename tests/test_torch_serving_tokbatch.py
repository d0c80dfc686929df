"""Token-level batched stepping (``step_mode="tokens"``) and the paged-attention
kernel path (``attn_impl="kernel"``) of the port's server on the CPU: the GQA
cases of ``tests/test_serving_tokbatch.py``. Within the port every contract
is exact: the flattened token batch gives the chunked engine's tokens per
cache layout (dense, paged, paged + the kernel's plain version) and per chunk
width C in {1, 4, 7}. Plus the padding rows of a token batch: they share a
live row's (slot, position) and must never land on it; and the runs of a
token batch (each slot's rows, for the kernel to read their context once):
built per step, checked on the host, carried by the step's one upload and
passed only on the kernel path."""
import numpy as np
import pytest
import torch

from test_torch_serve_util import CPU, one_cpu_thread, params, serve  # noqa: F401
from repro_torch.kernels.paged_attn import ref as pa_ref
from repro_torch.models import attention
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.serving import BatchedServer, Request, check_runs, token_runs

ARCHS = ["internlm2-20b", "mistral-nemo-12b"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("chunk", [1, 4, 7])
def test_tokens_vs_chunked_token_exact(arch, chunk):
    """C=7 >= the longest prompt, so whole prompts flatten in one step."""
    cfg, p = params(arch)
    ref, _ = serve(cfg, p, prefill_chunk=chunk)
    got, srv = serve(cfg, p, prefill_chunk=chunk, step_mode="tokens")
    assert srv.step_mode == "tokens" and got == ref
    for impl in ("gather", "kernel"):
        gotp, srvp = serve(cfg, p, prefill_chunk=chunk, step_mode="tokens", kv="paged",
                           block_size=4, attn_impl=impl)
        assert srvp.kv_mode == "paged" and srvp.attn_impl == impl and gotp == ref


def test_chunked_kernel_token_exact():
    cfg, p = params()
    ref, _ = serve(cfg, p, prefill_chunk=4)
    got, srv = serve(cfg, p, prefill_chunk=4, kv="paged", block_size=4, attn_impl="kernel")
    assert srv.step_mode == "chunked" and srv.attn_impl == "kernel" and got == ref


def test_tokens_ttft_steps_contract():
    cfg, p = params()
    for chunk in (1, 3, 4):
        _, srv = serve(cfg, p, stream=[([3, 1, 4, 1, 5], 2)], slots=1, prefill_chunk=chunk,
                       step_mode="tokens")
        assert srv.metrics.ttft_steps == [-(-5 // chunk)]


def test_invalid_flags_rejected():
    cfg, p = params()
    with pytest.raises(ValueError, match="step_mode"):
        BatchedServer(cfg, p, batch_slots=1, max_seq=8, step_mode="fused", device=CPU)
    with pytest.raises(ValueError, match="attn_impl"):
        BatchedServer(cfg, p, batch_slots=1, max_seq=8, attn_impl="cuda", device=CPU)


def test_batched_tokens_accounting():
    cfg, p = params()
    _, ch = serve(cfg, p, prefill_chunk=4)
    _, tk = serve(cfg, p, prefill_chunk=4, step_mode="tokens")
    assert ch.metrics.batched_tokens == ch.metrics.steps * 2 * 4
    assert 0 < tk.metrics.batched_tokens < ch.metrics.batched_tokens
    assert tk.metrics.tok_s_per_batched_tok > 0


# --------------------------- padding rows -------------------------------------
@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_padding_rows_never_land_on_a_live_write(kv):
    """One 3-token prompt in slot 0 with C=4 gives a token batch of 3 live
    rows (slot 0, positions 0-2) and 5 padding rows at (slot 0, position 0).
    They land in the spare row or block; clamped onto the live index they
    would overwrite position 0's K/V. The served tokens equal the one-token
    engine's, and position 0 of the cache holds the live token's K/V."""
    cfg, p = params("mistral-nemo-12b")
    stream = [([11, 12, 13], 4)]
    ref, _ = serve(cfg, p, stream=stream, slots=1, max_seq=8)
    kw = dict(kv="paged", block_size=4) if kv == "paged" else {}
    srv = BatchedServer(cfg, p, batch_slots=1, max_seq=8, prefill_chunk=4, step_mode="tokens",
                        device=CPU, **kw)
    srv.submit(Request(0, [11, 12, 13], 4))
    srv.step()  # the prefill step: 3 live rows, 5 padding rows
    k = srv.cache[0]["k"]
    live = k[:, 0, 0] if kv == "dense" else k[:, int(srv._paged.pool.table[0, 0]), 0]
    one = BatchedServer(cfg, p, batch_slots=1, max_seq=8, device=CPU, **kw)
    one.submit(Request(0, [11, 12, 13], 4))
    one.step()  # the one-token engine writes position 0 alone
    k1 = one.cache[0]["k"]
    want = k1[:, 0, 0] if kv == "dense" else k1[:, int(one._paged.pool.table[0, 0]), 0]
    assert torch.equal(live, want)
    assert srv.cache[0]["k"][:, -1].abs().sum() > 0  # the spare took the padding
    assert [r.out for r in srv.run()] == ref


def test_gated_write_index_lands_in_the_spare_block():
    table = torch.tensor([[2, 0], [1, 3]], dtype=torch.int32)
    pos = torch.tensor([5, 9], dtype=torch.int32)  # row 1 parks past its table
    blk, off = attention._paged_write_idx(table, pos, 4, 0, 7,
                                          torch.tensor([True, False]))
    assert blk.tolist() == [0, 7] and off.tolist() == [1, 1]


# --------------------- serving-accounting contracts ---------------------------
def test_deferral_episodes_not_steps():
    cfg, p = params()
    _, srv = serve(cfg, p, stream=[([1, 2, 3], 8), ([4, 5, 6], 6)], kv="paged",
                   block_size=4, kv_blocks=3)
    m = srv.metrics
    assert m.finished == 2 and m.deferrals == 1
    assert m.deferral_steps >= 3 and m.deferral_steps > m.deferrals


def test_two_requests_two_episodes():
    cfg, p = params()
    _, srv = serve(cfg, p, stream=[([1, 2, 3], 8), ([4, 5, 6], 6), ([7, 8], 5)],
                   kv="paged", block_size=4, kv_blocks=3)
    m = srv.metrics
    assert m.finished == 3 and m.deferrals == 2 and m.deferral_steps >= m.deferrals


def test_wall_s_includes_admission():
    cfg, p = params()
    srv = BatchedServer(cfg, p, batch_slots=2, max_seq=16, device=CPU)
    srv.submit(Request(0, [1, 2, 3], 2))
    srv.step()
    assert srv.metrics.admitted == 1 and srv.last_admit_s > 0.0
    assert 0.0 < srv.metrics.wall_s - srv.last_admit_s < srv.metrics.wall_s


def test_max_seq_falsy_zero_rejected():
    cfg, p = params()
    with pytest.raises(ValueError, match="max_seq"):
        BatchedServer(cfg, p, batch_slots=1, max_seq=0, device=CPU)


def test_metrics_roundtrip_new_fields():
    m = ServeMetrics(slots=2, steps=4, deferrals=1, deferral_steps=5, batched_tokens=24,
                     tokens_generated=8, wall_s=2.0)
    d = m.as_dict()
    assert d["deferral_steps"] == 5 and d["batched_tokens"] == 24
    assert d["step_batched_tokens"] == 6.0
    assert d["tok_s_per_batched_tok"] == pytest.approx((8 / 2.0) / 6.0)
    m2 = ServeMetrics.from_dict(d)
    assert m2.deferral_steps == 5 and m2.batched_tokens == 24


def test_one_host_read_per_fused_step(monkeypatch):
    """Each fused step reads the device back exactly once: one ``.cpu()``
    copy of the packed tokens and flags, in both step modes."""
    cfg, p = params()
    reads = []
    real = torch.Tensor.cpu

    def counted(self, *a, **kw):
        reads.append(tuple(self.shape))
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    for mode in ("chunked", "tokens"):
        reads.clear()
        _, srv = serve(cfg, p, prefill_chunk=3, step_mode=mode, kv="paged", block_size=4,
                       attn_impl="kernel")
        assert len(reads) == srv.metrics.steps, mode
    assert reads and all(len(s) == 1 for s in reads)  # tokens mode: (T,) samples
    assert np.all([s[0] % 8 == 0 for s in reads])


# ------------------- runs: one slot's rows grouped for B5 --------------------
def _record_paged_calls(monkeypatch):
    """Every ``gqa_decode_paged`` call's impl and runs, and every runs tensor
    that reaches the paged-attention kernel's plain version."""
    calls, reached = [], []
    real_layer, real_ref = attention.gqa_decode_paged, pa_ref.paged_attn_ref

    def layer(*a, **kw):
        calls.append((kw["impl"], kw.get("runs")))
        return real_layer(*a, **kw)

    def plain(*a, runs=None, **kw):
        reached.append(runs)
        return real_ref(*a, runs=runs, **kw)

    monkeypatch.setattr(attention, "gqa_decode_paged", layer)
    monkeypatch.setattr(pa_ref, "paged_attn_ref", plain)
    return calls, reached


def test_token_step_runs_group_each_slot_in_the_one_upload(monkeypatch):
    """At every token step of a reduced GQA model on paged KV, the runs the
    kernel path receives cover the batch's rows in order, once each; a run
    holds consecutive positions of one slot; and the runs are a view of the
    step's one upload, beside the tokens, slots, positions and live flags.
    The step still reads the device back once."""
    cfg, p = params("mistral-nemo-12b")
    calls, _ = _record_paged_calls(monkeypatch)
    srv = BatchedServer(cfg, p, batch_slots=3, max_seq=24, kv="paged", block_size=4,
                        step_mode="tokens", prefill_chunk=4, attn_impl="kernel", device=CPU)
    for i, (prompt, n) in enumerate([([5, 6, 7, 8, 9, 1], 5), ([1, 2], 3), ([9, 3, 9], 4),
                                     ([2, 7, 1, 1, 4], 3)]):
        srv.submit(Request(i, prompt, n))
    uploads, reads = [], []
    real_upload, real_cpu = srv._upload, torch.Tensor.cpu

    def upload(arr):
        out = real_upload(arr)
        uploads.append(out)
        return out

    def cpu(self, *a, **kw):
        reads.append(tuple(self.shape))
        return real_cpu(self, *a, **kw)

    srv._upload = upload
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    steps = grouped = 0
    while srv.queue or any(r is not None for r in srv.active):
        calls.clear()
        uploads.clear()
        srv.step()
        steps += 1
        if not calls:
            continue
        assert len(calls) == cfg.n_layers
        runs = calls[0][1]
        assert all(impl == "kernel" and r is runs for impl, r in calls)
        flat = uploads[-1]  # the step's batch: tokens, slots, positions, live, runs
        t = (flat.numel() - runs.numel()) // 4
        assert runs.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
        slots, pos = flat[t:2 * t], flat[2 * t:3 * t]
        first, count = runs[:, 0].tolist(), runs[:, 1].tolist()
        assert first[0] == 0 and sum(count) == t
        assert all(f + n == g for f, n, g in zip(first, count, first[1:]))
        for f, n in zip(first, count):
            assert (slots[f:f + n] == slots[f]).all()
            assert pos[f:f + n].tolist() == list(range(int(pos[f]), int(pos[f]) + n))
        grouped += max(count) > 1
    assert grouped > 0 and len(reads) == steps


def test_chunked_step_and_gather_path_pass_no_runs(monkeypatch):
    """Runs reach only the kernel path of token stepping: chunked stepping
    (each row a different slot) passes none, and the gather path, which
    does not read them, gets none."""
    cfg, p = params("mistral-nemo-12b")
    calls, reached = _record_paged_calls(monkeypatch)
    serve(cfg, p, prefill_chunk=4, kv="paged", block_size=4, attn_impl="kernel")
    assert calls and all(impl == "kernel" and runs is None for impl, runs in calls)
    assert reached and all(runs is None for runs in reached)
    calls.clear()
    reached.clear()
    serve(cfg, p, prefill_chunk=4, step_mode="tokens", kv="paged", block_size=4,
          attn_impl="gather")
    assert calls and all(impl == "gather" and runs is None for impl, runs in calls)
    assert not reached


def test_kernel_path_with_runs_equals_gather_path(monkeypatch):
    """The kernel path, given runs of up to 4 rows, serves the gather path's
    tokens (on the CPU through the plain version, which ignores runs: this
    pins the plumbing)."""
    cfg, p = params("mistral-nemo-12b")
    _, reached = _record_paged_calls(monkeypatch)
    want, _ = serve(cfg, p, prefill_chunk=4, step_mode="tokens", kv="paged", block_size=4,
                    attn_impl="gather")
    got, _ = serve(cfg, p, prefill_chunk=4, step_mode="tokens", kv="paged", block_size=4,
                   attn_impl="kernel")
    assert got == want
    assert reached and all(r is not None for r in reached)
    assert max(int(r[:, 1].max()) for r in reached) == 4


def test_runs_of_a_token_batch_are_checked_before_upload():
    slots = np.array([2, 2, 2, 0, 1, 1, 0, 0], np.int32)
    runs = token_runs([3, 1, 2], 8)
    assert runs.tolist() == [[0, 3], [3, 1], [4, 2], [6, 1], [7, 1]]
    check_runs(runs, slots)
    for bad in ([[0, 3], [3, 1], [4, 2], [6, 1], [7, 2]],  # past the batch
                [[0, 3], [4, 1], [4, 2], [6, 1], [7, 1]],  # a gap and an overlap
                [[0, 4], [4, 2], [6, 1], [7, 1]]):  # a run over two slots
        with pytest.raises(ValueError):
            check_runs(np.array(bad, np.int32), slots)
