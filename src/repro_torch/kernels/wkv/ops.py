"""Public WKV6 entry point, differentiable: the plain chunked version for CPU
tensors, the Hopper kernels B6 (forward) and B6-bwd (backward) for CUDA
tensors (counterpart of ``repro.kernels.wkv.ops``).

The JAX wrapper's ``use_kernel=`` has no counterpart: the tensors' device
picks the kernels or the plain version. There is no fallback: CUDA tensors
either launch the kernels or raise. Where the reference trains through its
jnp form because ``jax.grad`` cannot enter the Pallas kernel, the port's
gradient is a kernel too.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.wkv import kernel, ref


class _WKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, lw, u, state, chunk):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        if r.device.type == "cpu":
            y, s_out = ref.wkv_chunked_ref(r, k, v, lw, u, state, chunk)
            ctx.save_for_backward(r, k, v, lw, u, state)
            return y, s_out
        u32 = u.to(torch.float32).contiguous()
        y, s_out, states = kernel.wkv_forward(
            r.contiguous(), k.contiguous(), v.contiguous(), lw.contiguous(), u32,
            state.contiguous(), chunk, save_states=any(ctx.needs_input_grad[:6]))
        ctx.save_for_backward(r, k, v, lw, u, state, states, s_out)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, dstate):
        chunk = ctx.chunk
        if dy is None:
            y_shape = (*ctx.saved_tensors[0].shape[:3], ctx.saved_tensors[2].shape[-1])
            dy = ctx.saved_tensors[0].new_zeros(y_shape)
        if dy.device.type == "cpu":
            r, k, v, lw, u, state = ctx.saved_tensors
            return (*ref.wkv_bwd_ref(r, k, v, lw, u, state, chunk, dy, dstate), None)
        r, k, v, lw, u, state, states, s_out = ctx.saved_tensors
        dr, dk, dv, dlw, du, ds0 = kernel.wkv_backward(
            r.contiguous(), k.contiguous(), v.contiguous(), lw.contiguous(),
            u.to(torch.float32).contiguous(), state.contiguous(), states, s_out,
            dy.to(r.dtype).contiguous(),
            None if dstate is None else dstate.to(torch.float32).contiguous(), chunk)
        return dr, dk, dv, dlw, du.to(u.dtype), ds0.to(state.dtype), None


def wkv(r, k, v, lw, u, state, chunk: int):
    """Chunkwise WKV6: r/k/lw (B,T,H,K), v (B,T,H,V), u (H,K), state
    (B,H,K,V) f32, T a multiple of ``chunk``. Returns (y (B,T,H,V) in r's
    dtype, state_out (B,H,K,V) f32), differentiable in all six inputs."""
    return _WKV.apply(r, k, v, lw, u, state, chunk)
