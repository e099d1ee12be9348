"""Post-training int8 quantization for serving.

Counterpart of reverb_tpu/ops/quant.py with the same scheme and the same
arithmetic, site by site:

  - weights: symmetric per-output-channel int8, scale = absmax/127 (at
    least 1e-12), stored as `weight_q8` (int8) + `w_scale` (f32, one per
    output channel) under the module's state-dict prefix;
    `quantize_params_int8` picks the same parameters as the JAX package,
    by its regexes on the JAX tree's path (`convert.tree_key`);
  - activations: dynamic symmetric per-token int8 for a linear (absmax/127
    along the features, at least 1e-8), per sample for the subsampling
    conv, or a calibrated static scale (`a_scale`, one scalar per site);
  - the int8 × int8 product accumulates in int32: `torch._int_mm`
    (cuBLASLt on the card), the conv as im2col then `_int_mm`; the result
    is rescaled in f32 as acc · s · w_scale, left to right, and cast to
    the activation dtype.  Rounding is half-to-even on both sides, and
    every division is one IEEE division, on the card too (`_div`).

`_int_mm` on CUDA takes only M > 16 rows and K, N multiples of 8, so
`int_mm` pads the operands with zeros to those sizes (a zero row or column
adds nothing to an integer sum) and crops the result.  There is no other
route: a shape it refuses raises, and nothing dequantizes to a float
matmul.  The quantize and rescale passes are plain torch on both devices.

Calibration (`calibrate_activation_scales`) records each int8 site's
activation absmax into a `Calibration` object handed to the int8 modules
for the run (their `calib` attribute), keyed by the site's JAX path, so a
scale table passes between the packages; `apply_activation_scales` writes
the scales into the modules as `a_scale` buffers.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable

import torch
import torch.nn.functional as F

from reverb_tpu_torch.convert import tree_key

_F32 = torch.float32

# the JAX package's skip list (reverb_tpu/ops/quant.py:175-179), matched
# against the JAX tree's path of a parameter's module
DEFAULT_SKIP = (
    r'.*norm.*', r'.*cmvn.*', r'.*embed.*', r'.*pos_bias.*',
    r'.*ctc_lo.*',          # CTC head: log-probs feed beam scores directly
    r'.*depthwise_conv.*', r'.*pointwise_conv.*', r'.*conv.*',
)


def _div(t, d: float):
    """t / d as one IEEE division on every device: CUDA divides by a
    Python scalar as a product with its reciprocal, which rounds twice."""
    return torch.div(t, torch.full((), d, dtype=t.dtype, device=t.device))


def int_mm(a, w):
    """a (M, K) int8 @ w (N, K) int8ᵀ → (M, N) int32, exactly, through
    `torch._int_mm` with the weight read in place as a column-major
    (K, N) (cuBLASLt's TN int8 layout), the operands zero-padded to its
    CUDA shape rules (M > 16; K and N multiples of 8) and the result
    cropped."""
    M, K = a.shape
    N = w.shape[0]
    Mp, Kp, Np = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8
    if Kp != K:
        a = F.pad(a, (0, Kp - K))
        w = F.pad(w, (0, Kp - K))
    if Np != N:
        w = F.pad(w, (0, 0, 0, Np - N))
    if Mp != M:
        a = F.pad(a, (0, 0, 0, Mp - M))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:M, :N] if (Mp, Np) != (M, N) else out


def quantize_rows(x):
    """Dynamic per-token scales of x (..., K): (xq int8, s f32 (..., 1)),
    s = max(absmax/127, 1e-8)."""
    s = _div(x.abs().amax(-1, keepdim=True).to(_F32), 127.0)
    s = torch.clamp(s, min=1e-8)
    xq = torch.clamp(torch.round(x.to(_F32) / s), -127, 127).to(torch.int8)
    return xq, s


def quantize_static(x, a_scale):
    """x against a calibrated scalar scale: round(x · 127/a_scale) → int8."""
    # 127 / a_scale as one division (torch's `127.0 / t` is 127·(1/t),
    # two roundings)
    inv = torch.div(torch.full_like(a_scale, 127.0), a_scale).to(_F32)
    return torch.clamp(torch.round(x.to(_F32) * inv), -127,
                       127).to(torch.int8)


def matmul_acc(xq, w_q8):
    """xq (..., K) int8 × w_q8 (N, K) int8 → (..., N) int32."""
    K = xq.shape[-1]
    acc = int_mm(xq.reshape(-1, K), w_q8)
    return acc.reshape(*xq.shape[:-1], acc.shape[-1])


def int8_matmul(x, w_q8, w_scale):
    """x (..., K) f32/bf16 × w_q8 (N, K) int8 → (..., N) in x.dtype, with
    dynamic per-token activation scales."""
    xq, s = quantize_rows(x)
    y = matmul_acc(xq, w_q8).to(_F32) * s * w_scale.to(_F32)
    return y.to(x.dtype)


def int8_matmul_static(x, w_q8, w_scale, a_scale):
    """`int8_matmul` with a calibrated static activation scale (a 0-d f32
    tensor): no per-token absmax, one constant rescale per channel."""
    acc = matmul_acc(quantize_static(x, a_scale), w_q8)
    y = acc.to(_F32) * (_div(a_scale, 127.0) * w_scale.to(_F32))
    return y.to(x.dtype)


def conv_acc(xq, w_q8, stride, padding=(0, 0)):
    """int8 conv of xq (B, C, H, W) with w_q8 (O, C, kh, kw) → (B, O, H',
    W') int32: the patches (B·H'·W', C·kh·kw) taken as strided views of
    xq (im2col), then `int_mm`."""
    if padding[0] or padding[1]:
        xq = F.pad(xq, (padding[1], padding[1], padding[0], padding[0]))
    O, C, kh, kw = w_q8.shape
    B = xq.shape[0]
    p = xq.unfold(2, kh, stride[0]).unfold(3, kw, stride[1])
    Ho, Wo = p.shape[2], p.shape[3]
    cols = p.permute(0, 2, 3, 1, 4, 5).reshape(B * Ho * Wo, C * kh * kw)
    acc = int_mm(cols, w_q8.reshape(O, C * kh * kw))
    return acc.reshape(B, Ho, Wo, O).permute(0, 3, 1, 2)


def int8_conv2d(x, w_q8, w_scale, stride, padding=(0, 0), a_scale=None):
    """x (B, C, H, W) × w_q8 (O, C, kh, kw) int8 → (B, O, H', W') in
    x.dtype: a per-sample dynamic activation scale, max(absmax, 1e-8)/127,
    or the calibrated scalar `a_scale`/127."""
    if a_scale is not None:
        s = _div(a_scale, 127.0).to(_F32)
    else:
        s = x.abs().amax((1, 2, 3), keepdim=True)
        s = _div(torch.clamp(s.to(_F32), min=1e-8), 127.0)
    xq = torch.clamp(torch.round(x.to(_F32) / s), -127, 127).to(torch.int8)
    acc = conv_acc(xq, w_q8, stride, padding)
    y = acc.to(_F32) * s * w_scale.to(_F32)[None, :, None, None]
    return y.to(x.dtype)


def quantize_weight(w):
    """Per-output-channel int8 of w (N, ...) → (w_q8 int8, w_scale f32
    (N,)): scale = max(absmax over the other axes / 127, 1e-12)."""
    w = w.to(_F32)
    scale = _div(w.abs().amax(tuple(range(1, w.dim()))), 127.0)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.round(w / scale.reshape(-1, *([1] * (w.dim() - 1))))
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def quantize_params_int8(state_dict, skip=DEFAULT_SKIP) -> Dict:
    """A copy of a port state dict with each eligible `<m>.weight`
    replaced by `<m>.weight_q8` + `<m>.w_scale`, by the JAX package's rules
    on the JAX path of `<m>` (reverb_tpu/ops/quant.py:182-214): a 4-D
    weight under `.embed.conv` first (the subsampling convs), then a 2-D
    weight whose path no `skip` regex matches and whose module has no
    `running_mean`.  The tensors stay on their device; the others are
    passed on as they are."""
    skip_res = [re.compile(p) for p in skip]
    out = {}
    for key, val in state_dict.items():
        prefix, _, leaf = key.rpartition('.')
        if leaf != 'weight' or not prefix:
            out[key] = val
            continue
        path = tree_key(prefix)
        if val.dim() == 4 and '.embed.conv' in path:
            eligible = True
        else:
            eligible = (val.dim() == 2
                        and not any(r.match(path) for r in skip_res)
                        and f'{prefix}.running_mean' not in state_dict)
        if not eligible:
            out[key] = val
            continue
        out[f'{prefix}.weight_q8'], out[f'{prefix}.w_scale'] = \
            quantize_weight(val)
    return out


class Calibration:
    """Per-site running activation absmax of one calibration batch, keyed
    by the site's JAX path; the int8 modules record into it while it is
    their `calib`."""

    def __init__(self):
        self.maxima: Dict[str, torch.Tensor] = {}

    def record(self, path: str, x):
        am = x.abs().amax().to(_F32)
        prev = self.maxima.get(path)
        self.maxima[path] = am if prev is None else torch.maximum(prev, am)


def int8_sites(model) -> Dict[str, torch.nn.Module]:
    """{JAX path: module} of the model's int8 modules."""
    return {m.q8_path: m for m in model.modules()
            if getattr(m, 'weight_q8', None) is not None}


def calibrate_activation_scales(model, run_fn, batches: Iterable,
                                headroom: float = 1.0) -> Dict[str, float]:
    """Record each int8 site's activation absmax over representative
    batches: run_fn(model, *batch) runs the serving forward(s) whose sites
    are calibrated (without gradients), once per batch.  Returns {JAX
    path: headroom · max over batches} for the sites that saw a non-zero
    activation (reverb_tpu/ops/quant.py:111-152)."""
    sites = int8_sites(model)
    maxima: Dict[str, float] = {}
    for i, batch in enumerate(batches):
        calib = Calibration()
        for m in sites.values():
            m.calib = calib
        try:
            with torch.no_grad():
                run_fn(model, *batch)
        finally:
            for m in sites.values():
                m.calib = None
        if i == 0 and sites and not calib.maxima:
            raise ValueError('calibration forward recorded no int8 sites: '
                             'run_fn must run the model it is given')
        for k, v in calib.maxima.items():
            maxima[k] = max(maxima.get(k, 0.0), float(v))
    return {k: v * headroom for k, v in maxima.items() if v > 0.0}


def apply_activation_scales(model, scales: Dict[str, float]):
    """Give each int8 site of `model` named in `scales` its static scale
    (an `a_scale` f32 buffer, in the state dict); the others keep dynamic
    scales.  Returns the model."""
    for path, m in int8_sites(model).items():
        if path in scales:
            m.a_scale = torch.tensor(scales[path], dtype=_F32,
                                     device=m.weight_q8.device)
    return model
