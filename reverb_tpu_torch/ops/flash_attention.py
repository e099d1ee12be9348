"""Rel-pos self-attention (WeNet variant, no rel_shift): kernel K1 and its
plain PyTorch version.

Counterpart of reverb_tpu/ops/flash_attention.py (forward only):

    scores[i,j] = ((q_i+u)·k_j + (q_i+v)·p_j) / sqrt(dk),  keys >= kv_len
                  masked (score -1e9, probability 0)
    out         = softmax(scores) · V,  softmax in f32, probabilities cast
                  to V's dtype before the product

A CPU tensor takes the plain version; a CUDA tensor launches the hand-written
kernel (csrc/rel_pos_attention.cu) or raises — there is no fallback.
"""

from __future__ import annotations

import math

import torch

from reverb_tpu_torch import _build

_MASK_VALUE = -1e9
# kernel launches in this process (read by chip_smoke.py)
LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_DK = 64


def rel_pos_attention_plain(q, k, v, pos, pos_bias_u, pos_bias_v, kv_lens):
    """Plain formulation (mirrors reverb_tpu/ops/flash_attention.py
    `_xla_reference` with the kernel's cast points).

    q, k, v: (B, H, T, dk); pos: (1, H, Tk, dk); pos_bias_u/v: (H, dk);
    kv_lens: (B,) valid key counts.  Returns (B, H, Tq, dk) in v.dtype."""
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
    return torch.matmul(attn.to(v.dtype).to(f32), v.to(f32)).to(v.dtype)


def rel_pos_attention(q, k, v, pos, pos_bias_u, pos_bias_v, kv_lens):
    """Fused rel-pos attention.  Arguments as `rel_pos_attention_plain`;
    q/k/v may be strided views as long as the head dim is contiguous (the
    (B, T, H, dk) projection layout is read in place).  The result is a
    (B, H, Tq, dk) view of a (B, Tq, H, dk) buffer, so merging heads after it
    is free."""
    global LAUNCHES
    if q.device.type == 'cpu':
        return rel_pos_attention_plain(q, k, v, pos, pos_bias_u, pos_bias_v,
                                       kv_lens)
    if q.device.type != 'cuda':
        raise RuntimeError(f'rel_pos_attention: no kernel for {q.device}')
    B, H, Tq, dk = q.shape
    Tk = k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f'rel_pos_attention: unsupported dtype {q.dtype}')
    if dk != _KERNEL_DK:
        raise ValueError(f'rel_pos_attention: kernel built for dk=64, '
                         f'got {dk}')
    if k.shape != (B, H, Tk, dk) or v.shape != (B, H, Tk, dk):
        raise ValueError('rel_pos_attention: k/v shape mismatch')
    if pos.shape[0] != 1 or pos.shape[1] != H or pos.shape[2] < Tk \
            or pos.shape[3] != dk:
        raise ValueError(f'rel_pos_attention: pos shape {tuple(pos.shape)}')
    for name, x in (('q', q), ('k', k), ('v', v), ('pos', pos)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f'rel_pos_attention: {name} device/dtype '
                             f'differs from q')
        if x.stride(-1) != 1:
            raise ValueError(f'rel_pos_attention: {name} head dim must be '
                             f'contiguous')
    u = pos_bias_u.to(device=q.device, dtype=q.dtype).contiguous()
    vb = pos_bias_v.to(device=q.device, dtype=q.dtype).contiguous()
    if u.shape != (H, dk) or vb.shape != (H, dk):
        raise ValueError('rel_pos_attention: pos bias shape')
    lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    if lens.shape != (B,):
        raise ValueError('rel_pos_attention: kv_lens must be (B,)')
    out = torch.empty((B, Tq, H, dk), device=q.device, dtype=q.dtype)
    o = out.permute(0, 2, 1, 3)                        # (B, H, Tq, dk) view
    lib = _build.load()
    rc = lib.reverb_rel_pos_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        pos.data_ptr(), u.data_ptr(), vb.data_ptr(), lens.data_ptr(),
        out.data_ptr(), B, H, Tq, Tk,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2),
        pos.stride(1), pos.stride(2),
        1.0 / math.sqrt(dk), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, 'rel_pos_attention')
    LAUNCHES += 1
    return o
