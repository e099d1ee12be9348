"""CTC prefix beam search kernels K2 (forward frame scan) and K3
(backpointer walk), with their plain PyTorch versions.

Counterpart of reverb_tpu/ops/beam_scan.py.  `beam_scan_forward` runs every
frame of `decode/prefix_beam._step` in one launch per batch (one CUDA block
per utterance); `beam_backtrace` rebuilds the (B, K, L) token and time
matrices from the per-frame records, with the scatter-max fused in.  Both
take the plain version for CPU tensors and launch the kernel for CUDA
tensors (csrc/beam_scan.cu) — there is no fallback.  Unbiased search only.

Record layout (time-leading): eight (T, B, K) int32 arrays named by
`prefix_beam.EMIT_KEYS` plus `wval` (T, B) int32, the frame index written by
a time update.
"""

from __future__ import annotations

import torch

from reverb_tpu_torch import _build
from reverb_tpu_torch.decode.prefix_beam import (EMIT_KEYS, _backtrace,
                                                 _init_state, _step)

# kernel launches in this process (read by chip_smoke.py)
FWD_LAUNCHES = 0
BT_LAUNCHES = 0
_MAX_K = 16
_MAX_CAND = 128


def beam_scan_forward_plain(topk_logp, topk_idx, ts, valid, blank_acc,
                            has_skip, K: int, blank_id: int):
    """The frame loop of `prefix_beam._step`.  Returns (final {s, ns, v_s,
    v_ns, plen} (B, K), emits as in the module docstring)."""
    B, T, _ = topk_logp.shape
    state = _init_state(B, K, topk_logp.device)
    records = []
    for t in range(T):
        state, em = _step(state, topk_logp[:, t], topk_idx[:, t], ts[:, t],
                          valid[:, t], blank_acc[:, t], has_skip[:, t], K,
                          blank_id)
        records.append(em)
    dev = topk_logp.device
    emits = {n: (torch.stack([r[n] for r in records]) if T else
                 torch.zeros((0, B, K), dtype=torch.int32, device=dev))
             for n in EMIT_KEYS}
    emits['wval'] = (torch.stack([r['wval'] for r in records]) if T else
                     torch.zeros((0, B), dtype=torch.int32, device=dev))
    final = {n: state[n] for n in ('s', 'ns', 'v_s', 'v_ns', 'plen')}
    return final, emits


def beam_backtrace_plain(emits: dict, order, final_sel_ns, L: int):
    """Reverse walk + scatter-max (`prefix_beam._backtrace`)."""
    return _backtrace(emits, order, final_sel_ns, L)


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f'{name}: tensors on different devices')
        if not t.is_contiguous():
            raise ValueError(f'{name}: inputs must be contiguous')


def beam_scan_forward(topk_logp, topk_idx, ts, valid, blank_acc, has_skip,
                      K: int, blank_id: int):
    """topk_logp (B,T,K2) f32, topk_idx (B,T,K2) i32, ts (B,T) i32, valid
    and has_skip (B,T) bool, blank_acc (B,T) f32.  Returns (final, emits)
    as `beam_scan_forward_plain`."""
    global FWD_LAUNCHES
    if topk_logp.device.type == 'cpu':
        return beam_scan_forward_plain(topk_logp, topk_idx, ts, valid,
                                       blank_acc, has_skip, K, blank_id)
    if topk_logp.device.type != 'cuda':
        raise RuntimeError(f'beam_scan_forward: no kernel for '
                           f'{topk_logp.device}')
    B, T, K2 = topk_logp.shape
    if not (1 <= K <= _MAX_K and 1 <= K2 <= _MAX_K
            and K * (K2 + 1) <= _MAX_CAND):
        raise ValueError(f'beam_scan_forward: K={K}, K2={K2} outside the '
                         f'kernel limits')
    want = ((topk_logp, torch.float32, (B, T, K2)),
            (topk_idx, torch.int32, (B, T, K2)), (ts, torch.int32, (B, T)),
            (valid, torch.bool, (B, T)), (blank_acc, torch.float32, (B, T)),
            (has_skip, torch.bool, (B, T)))
    for x, dt, shape in want:
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f'beam_scan_forward: expected {dt} {shape}, '
                             f'got {x.dtype} {tuple(x.shape)}')
    _check_cuda('beam_scan_forward', *(w[0] for w in want))
    dev = topk_logp.device
    i32 = dict(dtype=torch.int32, device=dev)
    emits = {n: torch.empty((T, B, K), **i32) for n in EMIT_KEYS}
    emits['wval'] = torch.empty((T, B), **i32)
    final = {n: torch.empty((B, K), dtype=torch.float32, device=dev)
             for n in ('s', 'ns', 'v_s', 'v_ns')}
    final['plen'] = torch.empty((B, K), **i32)
    lib = _build.load()
    rc = lib.reverb_beam_scan_forward(
        topk_logp.data_ptr(), topk_idx.data_ptr(), ts.data_ptr(),
        valid.data_ptr(), blank_acc.data_ptr(), has_skip.data_ptr(),
        *(emits[n].data_ptr() for n in EMIT_KEYS + ('wval',)),
        *(final[n].data_ptr() for n in ('s', 'ns', 'v_s', 'v_ns', 'plen')),
        B, T, K, K2, blank_id, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'beam_scan_forward')
    FWD_LAUNCHES += 1
    return final, emits


def beam_backtrace(emits: dict, order, final_sel_ns, L: int):
    """emits from `beam_scan_forward`, order (B,K) i32, final_sel_ns (B,K)
    bool → (prefixes (B,K,L), times (B,K,L)) i32."""
    global BT_LAUNCHES
    if order.device.type == 'cpu':
        return beam_backtrace_plain(emits, order, final_sel_ns, L)
    if order.device.type != 'cuda':
        raise RuntimeError(f'beam_backtrace: no kernel for {order.device}')
    T, B, K = emits['pfx_parent'].shape
    for n in EMIT_KEYS:
        if emits[n].dtype != torch.int32 or emits[n].shape != (T, B, K):
            raise ValueError(f'beam_backtrace: bad record {n}')
    if emits['wval'].dtype != torch.int32 or emits['wval'].shape != (T, B):
        raise ValueError('beam_backtrace: bad record wval')
    order = order.to(torch.int32).contiguous()
    sel = final_sel_ns.to(torch.bool).contiguous()
    if order.shape != (B, K) or sel.shape != (B, K):
        raise ValueError('beam_backtrace: order/final_sel_ns must be (B, K)')
    _check_cuda('beam_backtrace', order, sel, emits['wval'],
                *(emits[n] for n in EMIT_KEYS))
    dev = order.device
    prefixes = torch.empty((B, K, L), dtype=torch.int32, device=dev)
    times = torch.empty((B, K, L), dtype=torch.int32, device=dev)
    lib = _build.load()
    rc = lib.reverb_beam_backtrace(
        *(emits[n].data_ptr() for n in EMIT_KEYS + ('wval',)),
        order.data_ptr(), sel.data_ptr(), prefixes.data_ptr(),
        times.data_ptr(), B, T, K, L,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'beam_backtrace')
    BT_LAUNCHES += 1
    return prefixes, times
