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
takes the plain versions and a CUDA tensor goes through the operator
`reverb::layer_norm` (a `torch.library.custom_op` with a fake for tracing,
its autograd K6), which launches the hand-written kernels
(csrc/layer_norm.cu) or raises — there is no fallback.
"""

from __future__ import annotations

import functools

import torch

from reverb_tpu_torch import _build

# kernel launches in this process (read by chip_smoke.py): K5 forwards and
# K6 backwards (one per backward call)
LAUNCHES = 0
BWD_LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_COLS = 8192
# the backward's blocks per SM: its launch bounds keep one 256-thread block
# of the warp-per-row kernel resident on each (csrc/layer_norm.cu)
_BWD_BLOCKS_PER_SM = 1


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


def rows_per_block(C: int) -> int:
    """Rows a backward block takes per step: 8 warps, one row each, up to
    C = 1024, then 8 / ceil(C / 1024) (csrc/layer_norm.cu `plan`)."""
    return max(1, 8 // -(-C // 1024))


def launch_plan(N: int, C: int, sms: int):
    """(blocks, iters) of the backward for N rows of width C on a card of
    `sms` SMs: about one wave of blocks, each taking `iters` steps of
    rows_per_block(C) rows, so that blocks · iters · rows ≥ N and every
    block has rows.  Its partial buffer is (blocks, C) per dgamma/dbeta."""
    rb = rows_per_block(C)
    blocks = min(-(-N // rb), sms * _BWD_BLOCKS_PER_SM)
    iters = -(-N // (rb * blocks))
    return -(-N // (rb * iters)), iters


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=4096)
def _plan(N: int, C: int, device_index: int):
    return launch_plan(N, C, _sms(device_index))


def _stream(x) -> int:
    """The raw current stream of x's device (what
    torch.cuda.current_stream(dev).cuda_stream returns, without building a
    Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def _f32_aligned(t):
    """t itself when it is f32, contiguous and 16-byte aligned (the model's
    parameters are), else such a copy of the (C,) parameter."""
    if t.dtype is not torch.float32 or not t.is_contiguous():
        t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _rows(x):
    """x itself when contiguous and 16-byte aligned, else such a copy; the
    kernels read it as (numel / C, C) rows."""
    if x.dtype not in _DTYPES:
        raise TypeError(f'layer_norm: unsupported dtype {x.dtype}')
    if not x.is_contiguous():
        x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def layer_norm_fwd(x, weight, bias, eps: float):
    """K5 on a CUDA tensor, the plain version on a CPU tensor."""
    global LAUNCHES
    if x.device.type == 'cpu':
        return layer_norm_plain(x, weight, bias, eps)
    if x.device.type != 'cuda' or not eligible(x):
        raise RuntimeError(f'layer_norm: no kernel for {x.device} '
                           f'{x.dtype} {tuple(x.shape)}')
    x2 = _rows(x)
    C = x2.shape[-1]
    y = torch.empty_like(x2)
    rc = _build.load().reverb_layer_norm_fwd(
        _DTYPES[x2.dtype], x2.data_ptr(), _f32_aligned(weight).data_ptr(),
        _f32_aligned(bias).data_ptr(), y.data_ptr(), x2.numel() // C, C, eps,
        _stream(x2))
    _build.check(rc, 'layer_norm')
    LAUNCHES += 1
    return y


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
    g2 = _rows(g if g.dtype == x.dtype else g.to(x.dtype))
    C = x2.shape[-1]
    N = x2.numel() // C
    blocks, iters = _plan(N, C, x2.get_device())
    dx = torch.empty_like(x2)
    # the (blocks, C) partials of dw and of db are scratch that dies with
    # this call; dw and db are the two rows of a result of their own, so a
    # kept gradient holds 2·C floats and not the scratch
    part = torch.empty((2 * blocks, C), device=x2.device, dtype=torch.float32)
    dwb = torch.empty((2, C), device=x2.device, dtype=torch.float32)
    p, q, row = part.data_ptr(), dwb.data_ptr(), 4 * C
    rc = _build.load().reverb_layer_norm_bwd(
        _DTYPES[x2.dtype], x2.data_ptr(), _f32_aligned(weight).data_ptr(),
        g2.data_ptr(), dx.data_ptr(), p, p + blocks * row, q, q + row, N, C,
        blocks, iters, eps, _stream(x2))
    _build.check(rc, 'layer_norm backward')
    BWD_LAUNCHES += 1
    return dx, dwb[0], dwb[1]


class _LayerNorm(torch.autograd.Function):
    """K5 forward, K6 backward through their wrappers, on CPU tensors:
    their plain versions, with the kernels' backward arithmetic."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return layer_norm_fwd(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        return (*_grads(x, weight, g, ctx.eps), None)


def _grads(x, weight, g, eps):
    dx, dw, db = layer_norm_bwd(x, weight, g, eps)
    if weight.dtype != torch.float32:
        dw, db = dw.to(weight.dtype), db.to(weight.dtype)
    return dx, dw, db


@torch.library.custom_op('reverb::layer_norm', mutates_args=(),
                         device_types='cuda')
def _layer_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """K5 as one operator (the counterpart of `fused_layer_norm`'s custom
    VJP): the dispatcher sees it whole, so `torch.export` keeps it in an
    exported graph (export/aot.py) and a selective checkpoint policy sees
    it.  Its gradient is K6."""
    return layer_norm_fwd(x, weight, bias, eps)


@_layer_norm_op.register_fake
def _(x, weight, bias, eps):
    return x.new_empty(x.shape)


def _layer_norm_setup(ctx, inputs, output):
    x, weight, _, eps = inputs
    ctx.save_for_backward(x, weight)
    ctx.eps = eps


def _layer_norm_backward(ctx, g):
    x, weight = ctx.saved_tensors
    return (*_grads(x, weight, g, ctx.eps), None)


_layer_norm_op.register_autograd(_layer_norm_backward,
                                 setup_context=_layer_norm_setup)
LAYER_NORM_OP = torch.ops.reverb.layer_norm.default


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis of x with f32 weight/bias (C,): the
    plain formulation for an ineligible shape; for an eligible one the
    plain versions of K5/K6 on a CPU tensor, and on a CUDA tensor the op
    `reverb::layer_norm` (K5, gradient K6)."""
    if not eligible(x):
        return layer_norm_plain(x, weight, bias, eps)
    if x.device.type == 'cpu':
        if torch.is_grad_enabled() and (x.requires_grad
                                        or weight.requires_grad
                                        or bias.requires_grad):
            return _LayerNorm.apply(x, weight, bias, eps)
        return layer_norm_fwd(x, weight, bias, eps)
    if x.device.type != 'cuda':
        raise RuntimeError(f'layer_norm: no kernel for {x.device}')
    return _layer_norm_op(x, weight, bias, eps)
