"""Row LayerNorm: kernels K5 (forward) and K6 (backward), and their plain
PyTorch versions.

Counterpart of reverb_tpu/ops/layer_norm.py (`_fwd_kernel`, `_bwd_kernel`,
the `fused_layer_norm` custom VJP).  Numerics as modules.layer_norm there:

    xf   = x in f32;  mean = E[xf];  var = max(E[xf²] − mean², 0)
    y    = ((xf − mean)·rsqrt(var + eps)).to(x.dtype) · w + b
    dx   = rstd·(g·w − mean(g·w) − x̂·mean(g·w·x̂))     (w in f32)
    dw   = Σ g·cast(x̂),  db = Σ g                     (f32)

The backward recomputes the row statistics, so only (x, w) are saved.
Eligibility is the reference's own rule (C % 128 == 0, C <= 8192, f32 or
bf16): an ineligible shape takes the plain formulation with autograd, as
the JAX package takes its XLA path.  For an eligible tensor a CPU tensor
takes the plain versions and a CUDA tensor launches the hand-written
kernels (csrc/layer_norm.cu) or raises — there is no fallback.
"""

from __future__ import annotations

import torch

from reverb_tpu_torch import _build

# kernel launches in this process (read by chip_smoke.py): K5 forwards and
# K6 backwards (one per backward call)
LAUNCHES = 0
BWD_LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_COLS = 8192
_SMS = 132          # H100 SXM: the backward sizes its grid to ~one wave


def eligible(x) -> bool:
    """The shapes the kernels take (reverb_tpu/ops/layer_norm.py:42-59)."""
    if x.dim() < 2:
        return False
    C = x.shape[-1]
    return C % 128 == 0 and C <= _MAX_COLS and x.dtype in _DTYPES


def layer_norm_plain(x, weight, bias, eps: float):
    """Plain formulation (reverb_tpu/models/modules.py:layer_norm)."""
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                      min=0.0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * weight.to(x.dtype) + bias.to(x.dtype)


def layer_norm_bwd_plain(x, weight, g, eps: float):
    """Plain version of K6 (reverb_tpu/ops/layer_norm.py:_bwd_kernel).
    Returns (dx in x.dtype, dw f32, db f32)."""
    C = x.shape[-1]
    xf = x.reshape(-1, C).to(torch.float32)
    gf = g.reshape(-1, C).to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                      min=0.0)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    gw = gf * weight.to(torch.float32)
    m1 = gw.mean(-1, keepdim=True)
    m2 = (gw * xhat).mean(-1, keepdim=True)
    dx = (rstd * (gw - m1 - xhat * m2)).to(x.dtype).reshape(x.shape)
    dw = (gf * xhat.to(x.dtype).to(torch.float32)).sum(0)
    db = gf.sum(0)
    return dx, dw, db


def _f32_aligned(t):
    """A contiguous, 16-byte aligned f32 copy of a (C,) parameter."""
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _rows(x):
    if x.dtype not in _DTYPES:
        raise TypeError(f'layer_norm: unsupported dtype {x.dtype}')
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    return x2


def layer_norm_fwd(x, weight, bias, eps: float):
    """K5 on a CUDA tensor, the plain version on a CPU tensor."""
    global LAUNCHES
    if x.device.type == 'cpu':
        return layer_norm_plain(x, weight, bias, eps)
    if x.device.type != 'cuda' or not eligible(x):
        raise RuntimeError(f'layer_norm: no kernel for {x.device} '
                           f'{x.dtype} {tuple(x.shape)}')
    x2 = _rows(x)
    N, C = x2.shape
    y = torch.empty_like(x2)
    lib = _build.load()
    rc = lib.reverb_layer_norm_fwd(
        _DTYPES[x.dtype], x2.data_ptr(), _f32_aligned(weight).data_ptr(),
        _f32_aligned(bias).data_ptr(), y.data_ptr(), N, C, eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, 'layer_norm')
    LAUNCHES += 1
    return y.reshape(x.shape)


def layer_norm_bwd(x, weight, g, eps: float):
    """K6 on a CUDA tensor, the plain version on a CPU tensor.  Returns
    (dx in x.dtype, dw f32, db f32)."""
    global BWD_LAUNCHES
    if x.device.type == 'cpu':
        return layer_norm_bwd_plain(x, weight, g, eps)
    if x.device.type != 'cuda' or not eligible(x):
        raise RuntimeError(f'layer_norm backward: no kernel for {x.device} '
                           f'{x.dtype} {tuple(x.shape)}')
    x2 = _rows(x)
    g2 = _rows(g.to(x.dtype))
    N, C = x2.shape
    lib = _build.load()
    rb = lib.reverb_layer_norm_rows_per_block(C)
    iters = max(1, -(-N // (rb * _SMS)))
    blocks = -(-N // (rb * iters))
    f32 = torch.float32
    dx = torch.empty_like(x2)
    part = torch.empty((2, blocks, C), device=x.device, dtype=f32)
    dwb = torch.empty((2, C), device=x.device, dtype=f32)
    rc = lib.reverb_layer_norm_bwd(
        _DTYPES[x.dtype], x2.data_ptr(), _f32_aligned(weight).data_ptr(),
        g2.data_ptr(), dx.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        dwb[0].data_ptr(), dwb[1].data_ptr(), N, C, blocks, iters, eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, 'layer_norm backward')
    BWD_LAUNCHES += 1
    return dx.reshape(x.shape), dwb[0], dwb[1]


class _LayerNorm(torch.autograd.Function):
    """K5 forward, K6 backward (the counterpart of `fused_layer_norm`'s
    custom VJP); on CPU tensors their plain versions."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return layer_norm_fwd(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x, weight, g, ctx.eps)
        return dx, dw.to(weight.dtype), db.to(weight.dtype), None


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis of x with f32 weight/bias (C,)."""
    if not eligible(x):
        return layer_norm_plain(x, weight, bias, eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, eps)
    return layer_norm_fwd(x, weight, bias, eps)
