"""Rel-pos self-attention (WeNet variant, no rel_shift): kernels K1 (forward)
and K4 (backward), and their plain PyTorch versions.

Counterpart of reverb_tpu/ops/flash_attention.py (`_attn_kernel`,
`_attn_bwd_kernel`, the `_flash_core` custom VJP):

    scores[i,j] = ((q_i+u)·k_j + (q_i+v)·p_j) / sqrt(dk),  keys >= kv_len
                  masked (score -1e9, probability 0)
    attn        = softmax(scores) in f32; with attention dropout, the
                  externally drawn int8 keep-mask scales kept entries by
                  1/(1-rate) and zeroes the rest
    out         = attn · V, probabilities cast to V's dtype first

A CPU tensor takes the plain version (and autograd through it); a CUDA
tensor launches the hand-written kernels or raises — there is no fallback:
bf16 goes to the tensor-core kernels (csrc/rel_pos_attention_bf16.cu), f32
to the f32 ones (csrc/rel_pos_attention.cu).  When a gradient is needed on
the card, the forward also keeps each row's logsumexp and the backward is
K4.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from reverb_tpu_torch import _build

_MASK_VALUE = -1e9
# kernel launches in this process (read by chip_smoke.py): K1 forwards and
# K4 backwards (one per backward call)
LAUNCHES = 0
BWD_LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_DK = 64
_TILE = 64          # K4's query tile: one du/dvb partial per tile


def rel_pos_attention_plain(q, k, v, pos, pos_bias_u, pos_bias_v, kv_lens,
                            mask=None, rate: float = 0.0):
    """Plain formulation (mirrors reverb_tpu/ops/flash_attention.py
    `_xla_reference` with the kernel's cast points).

    q, k, v: (B, H, T, dk); pos: (1, H, Tk, dk); pos_bias_u/v: (H, dk);
    kv_lens: (B,) valid key counts; mask: optional (B, H, Tq, Tk) int8
    dropout keep-mask applied with `rate`.  Returns (B, H, Tq, dk) in
    v.dtype."""
    dk = q.shape[-1]
    Tk = k.shape[2]
    u = pos_bias_u.to(q.dtype)[None, :, None, :]
    vb = pos_bias_v.to(q.dtype)[None, :, None, :]
    f32 = torch.float32
    ac = torch.matmul((q + u).to(f32), k.to(f32).transpose(-1, -2))
    bd = torch.matmul((q + vb).to(f32),
                      pos[:, :, :Tk].to(f32).transpose(-1, -2))
    scores = (ac + bd) / math.sqrt(dk)
    col = torch.arange(Tk, device=q.device)
    valid = (col[None, :] < kv_lens.to(q.device)[:, None])[:, None, None, :]
    scores = scores.masked_fill(~valid, _MASK_VALUE)
    attn = torch.softmax(scores, dim=-1).masked_fill(~valid, 0.0)
    if mask is not None and rate > 0.0:
        attn = torch.where(mask != 0, attn / (1.0 - rate),
                           torch.zeros((), dtype=f32, device=q.device))
    return torch.matmul(attn.to(v.dtype).to(f32), v.to(f32)).to(v.dtype)


def _strides(*tensors):
    """Host int64 array of the (batch, head, time) strides of each (B, H,
    T, dk) tensor, then the (head, time) strides of the (H, Tk, dk) table."""
    vals = []
    for t in tensors[:-1]:
        vals += [t.stride(0), t.stride(1), t.stride(2)]
    vals += [tensors[-1].stride(0), tensors[-1].stride(1)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _bthd(B, H, T, like):
    """A (B, H, T, dk) view of a fresh (B, T, H, dk) buffer: merging heads
    after it is free."""
    return torch.empty((B, T, H, _KERNEL_DK), device=like.device,
                       dtype=like.dtype).permute(0, 2, 1, 3)


def _aligned(t, strides: bool = True):
    """t itself when the bf16 kernels' 16-byte copies can read it in place
    (a 16-byte aligned start and, with `strides`, every stride but the last
    a multiple of 8 elements), else a contiguous copy."""
    if t.data_ptr() % 16 == 0 and (not strides or all(
            s % 8 == 0 for s in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _check(q, k, v, p, u, vb, lens, mask):
    B, H, Tq, dk = q.shape
    Tk = k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f'rel_pos_attention: unsupported dtype {q.dtype}')
    if dk != _KERNEL_DK:
        raise ValueError(f'rel_pos_attention: kernel built for dk=64, '
                         f'got {dk}')
    if k.shape != (B, H, Tk, dk) or v.shape != (B, H, Tk, dk):
        raise ValueError('rel_pos_attention: k/v shape mismatch')
    if p.shape != (H, Tk, dk):
        raise ValueError(f'rel_pos_attention: pos shape {tuple(p.shape)}')
    for name, x in (('q', q), ('k', k), ('v', v), ('pos', p), ('u', u),
                    ('vb', vb)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f'rel_pos_attention: {name} device/dtype '
                             f'differs from q')
        if x.stride(-1) != 1:
            raise ValueError(f'rel_pos_attention: {name} head dim must be '
                             f'contiguous')
    if u.shape != (H, dk) or vb.shape != (H, dk) or not (
            u.is_contiguous() and vb.is_contiguous()):
        raise ValueError('rel_pos_attention: pos bias shape')
    if lens.shape != (B,) or lens.dtype != torch.int32 or \
            lens.device != q.device:
        raise ValueError('rel_pos_attention: kv_lens must be (B,) int32 on '
                         'the device')
    if mask is not None and (mask.shape != (B, H, Tq, Tk)
                             or mask.dtype != torch.int8
                             or not mask.is_contiguous()
                             or mask.device != q.device):
        raise ValueError('rel_pos_attention: mask must be a contiguous '
                         '(B, H, Tq, Tk) int8 tensor on the device')


def _k1(q, k, v, p, u, vb, lens, mask, rate, want_lse: bool):
    """Launch K1.  Returns (out (B, H, Tq, dk) view, lse (B·H·Tq,) f32 or
    None)."""
    global LAUNCHES
    _check(q, k, v, p, u, vb, lens, mask)
    if q.dtype == torch.bfloat16:
        q, k, v, p, u, vb = map(_aligned, (q, k, v, p, u, vb))
        mask = None if mask is None else _aligned(mask, strides=False)
    B, H, Tq, dk = q.shape
    Tk = k.shape[2]
    o = _bthd(B, H, Tq, q)
    lse = (torch.empty(B * H * Tq, device=q.device, dtype=torch.float32)
           if want_lse else None)
    keep_scale = 1.0 / (1.0 - rate) if mask is not None else 1.0
    st = _strides(q, k, v, o, o, o, o, p)
    lib = _build.load()
    rc = lib.reverb_rel_pos_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        p.data_ptr(), u.data_ptr(), vb.data_ptr(), lens.data_ptr(),
        None if mask is None else mask.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), B, H, Tq, Tk, st,
        1.0 / math.sqrt(dk), keep_scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, 'rel_pos_attention')
    LAUNCHES += 1
    return o, lse


def _k4(q, k, v, p, u, vb, lens, mask, rate, out, lse, g):
    """Launch K4.  Returns (dq, dk, dv, dp (H, Tk, dk), du, dvb (H, dk)),
    each in the input dtype, as the TPU wrapper returns them."""
    global BWD_LAUNCHES
    B, H, Tq, dk = q.shape
    Tk = k.shape[2]
    if g.dtype != q.dtype:
        g = g.to(q.dtype)
    if g.stride(-1) != 1:
        g = g.contiguous()
    if q.dtype == torch.bfloat16:
        q, k, v, p, u, vb, out, g = map(_aligned, (q, k, v, p, u, vb, out, g))
        mask = None if mask is None else _aligned(mask, strides=False)
    dev = q.device
    f32 = torch.float32
    n_qt = (Tq + _TILE - 1) // _TILE
    dq, dkk, dv = _bthd(B, H, Tq, q), _bthd(B, H, Tk, q), _bthd(B, H, Tk, q)
    D = torch.empty(B * H * Tq, device=dev, dtype=f32)
    dp_rows = torch.empty((B, H, Tk, dk), device=dev, dtype=f32)
    du_part = torch.empty((B, H, n_qt, dk), device=dev, dtype=f32)
    dvb_part = torch.empty_like(du_part)
    keep_scale = 1.0 / (1.0 - rate) if mask is not None else 1.0
    st = _strides(q, k, v, out, g, dq, dkk, p)
    lib = _build.load()
    rc = lib.reverb_rel_pos_attention_bwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        p.data_ptr(), u.data_ptr(), vb.data_ptr(), lens.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        g.data_ptr(), lse.data_ptr(), D.data_ptr(), dq.data_ptr(),
        dkk.data_ptr(), dv.data_ptr(), dp_rows.data_ptr(), du_part.data_ptr(),
        dvb_part.data_ptr(), B, H, Tq, Tk, st, 1.0 / math.sqrt(dk),
        keep_scale, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'rel_pos_attention backward')
    BWD_LAUNCHES += 1
    # p, u and vb are shared by the batch rows of a head: reduce over them
    dp = dp_rows.sum(0).to(p.dtype)
    du = du_part.sum((0, 2)).to(u.dtype)
    dvb = dvb_part.sum((0, 2)).to(vb.dtype)
    return dq, dkk, dv, dp, du, dvb


@torch.library.custom_op('reverb::rel_pos_attention', mutates_args=(),
                         device_types='cuda')
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  p: torch.Tensor, u: torch.Tensor, vb: torch.Tensor,
                  lens: torch.Tensor, mask: Optional[torch.Tensor],
                  rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 with the row logsumexp kept, as one operator (the counterpart of
    `_flash_core`'s custom VJP): the dispatcher sees it whole, so a
    selective checkpoint policy can keep its outputs
    (models/modules.py:checkpoint_layer, 'dots'), which is what JAX's
    'attn_out' name does.  Its gradient is K4."""
    return _k1(q, k, v, p, u, vb, lens, mask, rate, want_lse=True)


@_attention_op.register_fake
def _(q, k, v, p, u, vb, lens, mask, rate):
    B, H, Tq, dk = q.shape
    out = q.new_empty((B, Tq, H, dk)).permute(0, 2, 1, 3)
    return out, q.new_empty((B * H * Tq,), dtype=torch.float32)


def _attention_setup(ctx, inputs, output):
    q, k, v, p, u, vb, lens, mask, rate = inputs
    ctx.save_for_backward(q, k, v, p, u, vb, lens, mask, *output)
    ctx.rate = rate


def _attention_backward(ctx, g, g_lse):
    q, k, v, p, u, vb, lens, mask, out, lse = ctx.saved_tensors
    grads = _k4(q, k, v, p, u, vb, lens, mask, ctx.rate, out, lse, g)
    return (*grads, None, None, None)


_attention_op.register_autograd(_attention_backward,
                                setup_context=_attention_setup)
ATTENTION_OP = torch.ops.reverb.rel_pos_attention.default


def rel_pos_attention(q, k, v, pos, pos_bias_u, pos_bias_v, kv_lens,
                      mask=None, rate: float = 0.0):
    """Fused rel-pos attention.  Arguments as `rel_pos_attention_plain`;
    q/k/v may be strided views as long as the head dim is contiguous (the
    (B, T, H, dk) projection layout is read in place).  The result is a
    (B, H, Tq, dk) view of a (B, Tq, H, dk) buffer, so merging heads after it
    is free.  Differentiable: on the card the backward is K4."""
    if q.device.type == 'cpu':
        return rel_pos_attention_plain(q, k, v, pos, pos_bias_u, pos_bias_v,
                                       kv_lens, mask, rate)
    if q.device.type != 'cuda':
        raise RuntimeError(f'rel_pos_attention: no kernel for {q.device}')
    Tk = k.shape[2]
    if pos.dim() != 4 or pos.shape[0] != 1 or pos.shape[2] < Tk:
        raise ValueError(f'rel_pos_attention: pos shape {tuple(pos.shape)}')
    if mask is not None and not rate > 0.0:
        mask = None
    p = pos[0, :, :Tk]
    u = pos_bias_u.to(device=q.device, dtype=q.dtype)
    vb = pos_bias_v.to(device=q.device, dtype=q.dtype)
    lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    # a traced program (torch.export) sees K1 only as the operator
    if torch.compiler.is_compiling() or torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, p, u, vb)):
        return _attention_op(q, k, v, p, u.contiguous(), vb.contiguous(),
                             lens, mask, rate)[0]
    return _k1(q, k, v, p, u.contiguous(), vb.contiguous(), lens, mask, rate,
               want_lse=False)[0]
