"""Parameter-holding layers with the JAX package's numerics.

Counterpart of reverb_tpu/models/modules.py.  Each layer keeps its
parameters in float32 under WeNet's state-dict names (`weight`, `bias`,
`running_mean`, ...) and casts them to the activation dtype at the point of
use, as the JAX functions do, so a bf16 forward rounds exactly where the
reference rounds.  Every layer also knows its own random initialization
(`reset_parameters(generator)`, torch-default bounds as in the JAX init),
so a model is built on the meta device and filled on its target device.

Dropout draws from an explicit `torch.Generator` (the counterpart of the
JAX package's rng): with no generator it is the identity, as with rng=None.
`checkpoint_layer` is the per-layer gradient checkpointing of the encoder
and decoder stacks (reverb_tpu/models/modules.py:remat_policy).
`Linear` and `Conv2d` also have an int8 serving form (`to_int8`,
ops/quant.py), which `models/asr_model.py:build_model` takes where the
state dict holds `weight_q8`.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from reverb_tpu_torch.ops import flash_attention as fa
from reverb_tpu_torch.ops import layer_norm as ln_ops
from reverb_tpu_torch.ops import quant

REMAT_POLICIES = ('full', 'dots', 'dots_no_ln')
_aten = torch.ops.aten
# what 'dots' keeps: the matmul and convolution outputs and the attention
# output of kernel K1 (with its logsumexp), so the backward neither
# recomputes a product nor replays K1 — JAX's dots_with_no_batch_dims
# plus its 'attn_out' name.  Batched matmuls (the masked attention's
# scores) are recomputed, as JAX recomputes dots with batch dimensions.
_SAVED_OPS = frozenset((_aten.mm.default, _aten.addmm.default,
                        _aten.convolution.default, fa.ATTENTION_OP))


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def check_remat_policy(policy: str):
    """Raise for a remat_policy that is not one of REMAT_POLICIES."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f'unknown remat_policy {policy!r} '
                         f'({"|".join(REMAT_POLICIES)})')


def checkpoint_layer(layer, policy: str, generator, *args):
    """layer(*args) under non-reentrant activation checkpointing: the
    forward keeps the layer's inputs (and under 'dots' / 'dots_no_ln' the
    outputs of `_SAVED_OPS`), and the backward replays the rest.

    'dots_no_ln' is 'dots' here: JAX's 'dots' also keeps the LayerNorm
    statistics, but the port's LayerNorm keeps none (K6 recomputes them
    from its input), so there is nothing to leave out.

    The replay draws the same dropout masks: torch's preserve_rng_state
    restores only the default generators, so the explicit `generator`'s
    state is taken before the forward, set again for the replay, and put
    back after it, where the backward found it.  The forward leaves the
    generator where an unchecked layer leaves it, so later draws do not
    shift."""
    start = generator.get_state()
    replay = False

    def run(*a):
        nonlocal replay
        if not replay:
            replay = True
            return layer(*a)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return layer(*a)
        finally:
            generator.set_state(now)

    context_fn = ckpt.noop_context_fn
    if policy != 'full':
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    # the layers draw only from `generator`: the default generators need
    # no saving
    return ckpt.checkpoint(run, *args, use_reentrant=False,
                           preserve_rng_state=False, context_fn=context_fn)


def dropout(x, rate: float, generator=None):
    """reverb_tpu/models/modules.py:dropout — keep with probability
    1 − rate and scale kept entries by 1/(1 − rate), in x's dtype; the
    identity without a generator or at rate 0."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _uniform(t: torch.Tensor, bound: float, g):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=g)


class _Int8Form:
    """The int8 serving form of a layer (ops/quant.py): `to_int8` swaps the
    float `weight` for the buffers `weight_q8` (int8, the weight's shape)
    and `w_scale` (f32, one per output channel), and `a_scale` (a 0-d f32
    static activation scale) where the state dict to load holds one.
    `q8_path` is the site's JAX path and `calib` the calibration context
    it records its input into, while one is set."""

    def _init_int8(self):
        self.register_buffer('weight_q8', None)
        self.register_buffer('w_scale', None)
        self.register_buffer('a_scale', None)
        self.q8_path = None
        self.calib = None

    def to_int8(self, path: str, a_scale: bool = False):
        w = self.weight
        del self.weight
        self.register_parameter('weight', None)
        self.weight_q8 = torch.empty(w.shape, dtype=torch.int8,
                                     device=w.device)
        self.w_scale = torch.empty(w.shape[0], device=w.device)
        if a_scale:
            self.a_scale = torch.empty((), device=w.device)
        self.q8_path = path
        return self

    def _int8_input(self, x):
        if self.calib is not None:
            self.calib.record(self.q8_path, x)
        return x


class Linear(_Int8Form, nn.Module):
    """y = x Wᵀ + b with W (out, in) cast to x.dtype; in the int8 form
    (reverb_tpu/models/modules.py:linear with `weight_q8`) the int8
    product rescaled to x.dtype, static when `a_scale` is set, plus the
    bias in that dtype."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self._init_int8()

    def reset_parameters(self, g):
        bound = math.sqrt(1.0 / self.weight.shape[1])
        _uniform(self.weight, math.sqrt(3.0) * bound, g)
        if self.bias is not None:
            _uniform(self.bias, bound, g)

    def forward(self, x):
        if self.weight_q8 is not None:
            x = self._int8_input(x)
            if self.a_scale is not None:
                y = quant.int8_matmul_static(x, self.weight_q8, self.w_scale,
                                             self.a_scale)
            else:
                y = quant.int8_matmul(x, self.weight_q8, self.w_scale)
            return y if self.bias is None else y + self.bias.to(y.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv1d(nn.Module):
    """Conv1d parameters (out, in/groups, k) + bias, used pointwise (as a
    matmul over channels) or depthwise over time in (B, T, C) layout."""

    def __init__(self, in_ch: int, out_ch: int, k: int, groups: int = 1,
                 bias: bool = True):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, k))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def reset_parameters(self, g):
        fan_in = self.weight.shape[1] * self.weight.shape[2]
        bound = math.sqrt(1.0 / fan_in)
        _uniform(self.weight, math.sqrt(3.0) * bound, g)
        if self.bias is not None:
            _uniform(self.bias, bound, g)

    def pointwise(self, x):
        """1×1 conv over the channel axis of x (B, T, C_in)."""
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight[:, :, 0].to(x.dtype), b)

    def depthwise(self, x, padding: int):
        """Depthwise conv over time of x (B, T, C) → (B, T', C)."""
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv1d(x.transpose(1, 2), self.weight.to(x.dtype), b,
                     padding=padding, groups=self.groups)
        return y.transpose(1, 2)


class Conv2d(_Int8Form, nn.Module):
    """2-D convolution, no padding; in the int8 form
    (reverb_tpu/models/modules.py:conv2d with `weight_q8`) im2col and the
    int8 product with a per-sample (or static) activation scale."""

    def __init__(self, in_ch: int, out_ch: int, kh: int, kw: int,
                 stride=(1, 1)):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self._init_int8()

    def reset_parameters(self, g):
        w = self.weight
        bound = math.sqrt(1.0 / (w.shape[1] * w.shape[2] * w.shape[3]))
        _uniform(w, math.sqrt(3.0) * bound, g)
        _uniform(self.bias, bound, g)

    def forward(self, x):
        if self.weight_q8 is not None:
            y = quant.int8_conv2d(self._int8_input(x), self.weight_q8,
                                  self.w_scale, self.stride,
                                  a_scale=self.a_scale)
            return y + self.bias[None, :, None, None].to(y.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        stride=self.stride)


class LayerNorm(nn.Module):
    """LayerNorm with one-pass f32 statistics (E[x²] − E[x]², clamped at
    0), normalized values cast to x.dtype BEFORE the affine
    (reverb_tpu/models/modules.py:layer_norm), through kernels K5/K6
    (ops/layer_norm.py) wherever the shape is eligible."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, g):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return ln_ops.layer_norm(x, self.weight, self.bias, self.eps)


class BatchNorm(nn.Module):
    """BatchNorm over the LAST axis of (B, T, C) from running stats; scale/
    shift are folded in f32 and cast to x.dtype.

    As in the JAX package (batch_norm_last, init_batch_norm), the running
    statistics are always used, also when training, and they are trainable
    leaves: parameters that receive gradients and optimizer updates (the
    state-dict keys stay WeNet's)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.running_mean = nn.Parameter(torch.empty(dim))
        self.running_var = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, g):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        rstd = torch.rsqrt(self.running_var + self.eps)
        scale = (self.weight * rstd).to(x.dtype)
        shift = (self.bias - self.weight * self.running_mean * rstd
                 ).to(x.dtype)
        return x * scale + shift


class Embedding(nn.Module):
    def __init__(self, num: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim))

    def reset_parameters(self, g):
        with torch.no_grad():
            self.weight.normal_(generator=g)

    def forward(self, ids):
        return self.weight[ids]


def swish(x):
    return x * torch.sigmoid(x)


def glu(x, dim: int = -1):
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


ACTIVATIONS = {
    'relu': torch.relu,
    'swish': swish,
    'silu': swish,
    'gelu': F.gelu,
    'tanh': torch.tanh,
}


def reset_parameters(model: nn.Module, generator: torch.Generator):
    """Initialize every layer of `model` from `generator`, in module order."""
    for m in model.modules():
        if hasattr(m, 'reset_parameters'):
            m.reset_parameters(generator)
