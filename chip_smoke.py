#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (reverb_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

    python3 chip_smoke.py --phases kernels      # only the kernel checks

    python3 chip_smoke.py --phases modes        # only the six CLI modes

    python3 chip_smoke.py --profile             # + one profiled train step

    python3 chip_smoke.py --ab-parent DIR       # + K1-K6 of the checkout
                                                #   DIR, timed in turns

Run from the root of a checkout.  It builds the port's CUDA kernels from
reverb_tpu_torch/csrc, holds each kernel to its plain PyTorch version at
the shapes of the paths below (attention also at a ragged T = 333,
LayerNorm also at 1 and 640 rows, the beam also at the shapes of
BEAM_CASES), times
each beside its bound and the one PyTorch call that computes the same
function (its library yardstick, which the port never calls) — per call
(CUDA events around back-to-back calls, host work included) and on the
device alone (the profiler's kernel durations) — then drives
three paths on a reverb_large-
width model (18-layer LSL conformer, d=1024, 16 heads, 6+3-layer
bitransformer decoder, V=10000) with seeded random weights:

- serving: `ReverbASR.transcribe_modes(['ctc_prefix_beam_search',
  'attention_rescoring'], format='ctm')` in bf16 on a synthetic 164 s wav
  (8 chunks of 2051 frames) — kernels K1, K2, K3, K5; then once more with
  a decode whose max_hyp_len every chunk overflows, which must complete
  through the uncapped tail (K2 and K3 twice per encoder call);
- training: `make_train_step` (hybrid CTC/attention loss, dropout 0.1,
  Adam with warmuplr, clip 50) — first one f32 step at B = 2 through the
  kernels and through the plain versions with the same dropout draws, then
  4 bf16 steps at B = 8 utterances of 1600-2051 frames — kernels K1 (with
  the dropout keep-mask), K4, K5, K6;
- the six CLI modes (attention, ctc_greedy_search, ctc_prefix_beam_search,
  attention_rescoring, joint_decoding, onmt_attention_decoding): first on
  one f32 chunk's encoder output with the kernels and with the plain
  versions (equal; joint_decoding also at ctc_weight 0.5, where it emits
  tokens), then one bf16 `transcribe_modes` call with all six on
  the 164 s wav after a warm-up call — kernels K1, K5 (encoder and every
  decoder step), K2 and K3 (once per encoder call, over the dense CTC
  table) — and each mode alone, timed.

Each path runs with the launch counters set to 0 just before it and read
just after.  Every phase raises on failure; the exit code is 0 only when
all of them pass.

Output: progress lines, then the card's `nvidia-smi` name and power limit,
then one JSON line {"kernels": [...]} (each kernel's launches on the
three paths, its error against the plain version, its time per call and on the
device alone, the plain version's, the library call's per call and on
the device alone, and the bound), and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import tempfile
import time
import warnings
import wave
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MODES = ['ctc_prefix_beam_search', 'attention_rescoring']
CHUNK = 2051                 # frames per chunk (CLI default)
N_CHUNKS = 8                 # one full batch of the auto batcher
VOCAB = 10000
SEED = 0                     # weights, audio and beam inputs
LAYERS_ENC, LN_ENC, LN_DEC = 18, 91, 29   # reverb_large: per-step counts
TRAIN_B, TRAIN_STEPS = 8, 4
ALL_PHASES = ('kernels', 'serve', 'train', 'modes')


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    """ms per call of fn() between CUDA events around `reps` back-to-back
    calls, after one warm-up: what a path pays per call, the host's work
    included where it exceeds the device's."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_of(events, reps: int, pattern=None) -> float:
    """Device ms per call from profiler events (name, start µs, end µs): the
    summed durations of those whose name matches the regex `pattern` (all
    when None), over `reps` calls."""
    pat = re.compile(pattern) if pattern else None
    us = sum(end - start for name, start, end in events
             if pat is None or pat.search(name))
    return us / reps / 1e3


def device_ms_by_name(events, reps: int, pattern) -> float:
    """Device ms per call from profiler events (name, start µs, end µs) of
    the kernels matching `pattern`, robust to traces that lost some of
    the events: for each distinct kernel name, its mean duration times its
    launches per call (events over `reps`, rounded, at least 1).  With no
    event lost this is device_ms_of."""
    pat = re.compile(pattern)
    by_name = {}
    for name, start, end in events:
        if pat.search(name):
            tot = by_name.setdefault(name, [0.0, 0])
            tot[0] += end - start
            tot[1] += 1
    return sum(us / n * max(1, round(n / reps))
               for us, n in by_name.values()) / 1e3


def device_time_ms(fn, reps: int, pattern=None) -> float:
    """Device-alone ms per call of fn(): `reps` calls under torch.profiler
    (CUDA activity) after one warm-up; the durations of the kernels and
    memcpy/memset the calls launched, restricted to names matching
    `pattern` when given.  The profiler on the H100 has returned traces
    with no device event at all, and traces that hold only some of the
    calls' events (3 of 5 launches of one kernel, in a process that had
    profiled much before): a sum over `reps` would then read 0.6 of the
    true time.  So a trace whose matching events are no multiple of
    `reps` is run again, at most 3 in all; of those the one with the most
    events is kept, and a named kernel's time is its mean event duration
    (device_ms_by_name).  It raises when no trace saw device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pat = re.compile(pattern) if pattern else None
    fn()
    torch.cuda.synchronize()
    best, best_n = [], -1
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.device_type == DeviceType.CUDA]
        n = sum(1 for name, _, _ in events if pat is None or pat.search(name))
        if n > best_n:
            best, best_n = events, n
        # an unnamed yardstick may launch some kernel once, not per call
        if n and (pat is None or n % reps == 0):
            break
        log(f'profiler: {n} events of {pattern!r} for {reps} calls in '
            f'trace {attempt + 1}; again')
    if pat is None:
        ms = device_ms_of(best, reps)
    else:
        ms = device_ms_by_name(best, reps, pattern)
        if best_n % reps:
            log(f'profiler: kept the trace with {best_n} events; time '
                f'from their mean duration')
    if not ms > 0:
        raise AssertionError(f'the profiler saw no device time (pattern '
                             f'{pattern!r}, {len(best)} device events)')
    return ms


def both_times(fn, reps: int, pattern=None):
    """(event ms per call, device-alone ms per call) of fn()."""
    return cuda_time_ms(fn, reps), device_time_ms(fn, reps, pattern)


# each kernel's device events, by name (the profiler's demangled names)
KERNEL_PATTERNS = {
    'K1': r'reverb_rpa.*fwd_kernel|rel_pos_attn_kernel',
    'K2': r'beam_scan_kernel',
    'K3': r'beam_backtrace_kernel',
    'K4': r'attn_bwd_rowdot|reverb_rpa.*(dkdv|dq)_kernel|attn_bwd_d',
    'K5': r'ln_fwd',
    'K6': r'ln_(bwd|colsum)',
}


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): the bf16
# tensor-core rate, the f32 rate outside the tensor cores, the HBM rate.
PEAK_OPS = {'bf16': 989e12, 'f32': 67e12}
HBM_BYTES_S = 3.35e12


def nbytes(*objs) -> int:
    """Bytes of every tensor in objs (nested tuples, lists, dicts)."""
    import torch
    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += nbytes(*o)
        elif isinstance(o, dict):
            total += nbytes(*o.values())
    return total


def bound(ops: float, n_bytes: int, kind: str):
    """(bound_ms, bound_by): the least time the card could take — the
    larger of the operations over the peak rate of their type and the bytes
    (each input read once, each output written once) over the HBM rate."""
    t_ops = ops / PEAK_OPS[kind] * 1e3
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def attn_ops(T: int, backward: bool) -> float:
    """Matrix-product operations of K1 (S over depth 128, P·V) or of K4 at
    its minimum (S once, g·vᵀ, dv, dk, dp over depth 64, dq over depth 128)
    for B·H rows of T queries against T keys, every row at full length."""
    pairs = ATTN_B * ATTN_H * T * T
    return pairs * (1024 if backward else 384)


# ------------------------------ phase 3: K1 ------------------------------

# the kernel checks' shapes: T = 512 (a full chunk) and a ragged T = 333
# (a file's last chunk), kv_lens ragged with 0 and 1 among them
ATTN_CASES = {512: [512, 300, 1, 0, 512, 17, 64, 65],
              333: [333, 200, 1, 0, 333, 17, 64, 65]}
ATTN_B, ATTN_H, ATTN_DK, ATTN_T = 8, 16, 64, 512   # timed at T = 512


def attn_inputs(dev, gen, dtype, T):
    """Unit-scale q, k, v (read through strides from (B, T, H, dk), as the
    encoder passes them), the rel-pos table and the two biases."""
    import torch
    B, H, dk = ATTN_B, ATTN_H, ATTN_DK

    def rnd(*shape):
        return (torch.rand(*shape, device=dev, generator=gen) * 2 - 1).to(
            dtype)
    q, k, v = (rnd(B, T, H, dk).transpose(1, 2) for _ in range(3))
    pos = rnd(1, H, T, dk)
    u, vb = rnd(H, dk).float() * 0.1, rnd(H, dk).float() * 0.1
    return q, k, v, pos, u, vb


def check_k1(dev):
    """K1 against its plain version at B·H = 8·16, dk = 64, in each of
    ATTN_CASES, valid rows only.  f32: ≤ 1e-4 (summation order only).
    bf16 on unit-scale inputs (|out| ≤ 1): ≤ 2e-2 (the output is rounded to
    bf16).  A kv_len of 0 gives a zero row.  Times kernel and plain version
    at T = 512, every row at full length."""
    import torch
    from reverb_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        errs = {}
        for T, lens in ATTN_CASES.items():
            lens = torch.tensor(lens, device=dev)
            args = (*attn_inputs(dev, gen, dtype, T), lens)
            got = fa.rel_pos_attention(*args)
            want = fa.rel_pos_attention_plain(*args)
            torch.cuda.synchronize()
            err = 0.0
            for b in range(ATTN_B):
                L = int(lens[b])
                if L == 0:
                    if torch.count_nonzero(got[b]):
                        raise AssertionError(f'K1 T={T}: kv_len 0 row is '
                                             f'not 0')
                    continue
                err = max(err, float((got[b, :, :L].float()
                                      - want[b, :, :L].float()).abs().max()))
            if not err <= tol:
                raise AssertionError(f'K1 {dtype} T={T}: max abs err {err} '
                                     f'> {tol}')
            errs[f'T{T}'] = err
        # timed as the encoder calls it: every row at the full T
        T = ATTN_T
        full = (*attn_inputs(dev, gen, dtype, T),
                torch.full((ATTN_B,), T, device=dev))
        ms, dev_ms = both_times(lambda: fa.rel_pos_attention(*full), 20,
                                KERNEL_PATTERNS['K1'])
        plain_ms = cuda_time_ms(lambda: fa.rel_pos_attention_plain(*full), 20)
        log(f'K1 rel_pos_attention {dtype}: max_abs_err {errs} (tol {tol}); '
            f'all rows at T={T}: kernel {ms:.4f} ms per call, {dev_ms:.4f} '
            f'ms on the device; plain {plain_ms:.4f} ms')
        out[dtype] = dict(errs=errs, ms=ms, device_ms=dev_ms,
                          plain_ms=plain_ms, nbytes=nbytes(full, full[0]))
    return out


def sdpa_yardstick(dev, rate=0.1):
    """The one PyTorch call that computes K1's function (its library
    yardstick; the port never calls it): scaled_dot_product_attention
    of [q+u | q+v] against [k | p] (depth 128) and v, scale 1/sqrt(dk),
    every row at full length, bf16 at the timed shape.  Times the forward,
    the forward with dropout_p = rate (its draw differs from the keep-mask:
    time only) and torch.autograd.grad through the dropout call, on each
    fused backend that takes these shapes; returns the fastest of each
    (by per-call time) as (ms, backend's name, device-alone ms)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, pos, u, vb = attn_inputs(dev, gen, torch.bfloat16, ATTN_T)
    B, dk = ATTN_B, ATTN_DK
    qc = torch.cat([q + u.to(q.dtype)[None, :, None],
                    q + vb.to(q.dtype)[None, :, None]], -1).contiguous()
    kc = torch.cat([k, pos.expand(B, -1, -1, -1)], -1).contiguous()
    vc = v.contiguous()
    g = torch.rand(vc.shape, device=dev, generator=gen).to(vc.dtype)
    scale = 1.0 / math.sqrt(dk)
    best = {}
    for be in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
               SDPBackend.EFFICIENT_ATTENTION):
        with sdpa_kernel([be]), warnings.catch_warnings():
            warnings.simplefilter('ignore')   # "kernel not used because"
            try:
                F.scaled_dot_product_attention(qc, kc, vc, scale=scale)
                torch.cuda.synchronize()
            except RuntimeError:
                continue            # this backend does not take the shapes
            t = {'fwd': both_times(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, scale=scale), 20)}
            try:
                t['fwd_drop'] = both_times(
                    lambda: F.scaled_dot_product_attention(
                        qc, kc, vc, dropout_p=rate, scale=scale), 20)
                ins = [x.detach().requires_grad_(True) for x in (qc, kc, vc)]
                o = F.scaled_dot_product_attention(*ins, dropout_p=rate,
                                                   scale=scale)
                t['bwd_drop'] = both_times(lambda: torch.autograd.grad(
                    o, ins, g, retain_graph=True), 20)
                del o, ins
            except RuntimeError:
                pass
        log(f'SDPA yardstick {be.name}: ' + ', '.join(
            f'{n} {ms:.4f} ms per call ({dev:.4f} on the device)'
            for n, (ms, dev) in t.items()))
        for n, (ms, dev) in t.items():
            if n not in best or ms < best[n][0]:
                best[n] = (ms, be.name, dev)
    if 'fwd' not in best:
        raise AssertionError('no fused SDPA backend takes the yardstick')
    return best


# ------------------------------ phase 4: K2 + K3 ------------------------------

def peaky_topk(dev, seed, B=8, T=512, K=10, V=VOCAB):
    """Per-frame top-K CTC log-probs shaped like a trained model's:
    65-85% of frames blank-top (as bench.py shapes its CTC head)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn(B, T, V, device=dev, generator=gen) * 2
    share = 0.65 + 0.2 * torch.rand(B, 1, device=dev, generator=gen)
    top_nb = logits[..., 1:].amax(-1)
    blank_top = torch.rand(B, T, device=dev, generator=gen) < share
    logits[..., 0] = torch.where(blank_top, top_nb + 3.0, top_nb - 1.0)
    logp = torch.log_softmax(logits, -1)
    vals, idx = torch.sort(logp, dim=-1, descending=True, stable=True)
    return (vals[..., :K].contiguous(), idx[..., :K].to(torch.int32)
            .contiguous(), logp[..., 0].contiguous())


# further shapes of the K2/K3 check: (name, B, T, K, K2, lens, max_tokens,
# blank-skip threshold).  The scan's ring takes 32 frames a stage and the
# walk's 64; lens None is every row at full length; max_tokens 0 is L = T
# (the uncapped search).  Small in B·T: the plain loop is ~5 ms a frame.
BEAM_CASES = [
    ('T=1', 2, 1, 10, 10, None, 256, 0.0),
    ('T=45, no multiple of a chunk', 3, 45, 10, 10, [45, 44, 1], 256, 0.0),
    ('T=150 > two chunks, a row of 0 frames, L=T', 4, 150, 10, 10,
     [150, 0, 129, 64], 0, 0.0),
    ('T=150, L=256', 4, 150, 10, 10, [150, 0, 129, 64], 256, 0.0),
    ('T=150 blank-skip 0.9, L=cap', 4, 150, 10, 10, [150, 0, 129, 64], 0,
     0.9),
    ('K=16, K2=7 (128 candidates)', 3, 70, 16, 7, [70, 33, 65], 256, 0.0),
    ('K=K2=4', 3, 70, 4, 4, [70, 33, 65], 64, 0.0),
    ('B=1', 1, 40, 10, 10, None, 256, 0.0),
    ('B=40', 40, 33, 10, 10, None, 32, 0.0),
    ('forced ties (every log-prob equal)', 2, 40, 6, 6, [40, 23], 40, 0.0),
]


def tied_topk(dev, B, T, K2):
    """Top-k inputs whose log-probs are all -1.5, tokens 1..K2 (row 1 lists
    the blank in every other frame): every extension of a frame ties, so
    the selection is decided by the flat index alone."""
    import torch
    lp = torch.full((B, T, K2), -1.5, device=dev)
    ix = torch.arange(1, K2 + 1, dtype=torch.int32, device=dev).repeat(
        B, T, 1)
    ix[1, ::2] = torch.arange(K2, dtype=torch.int32, device=dev)
    return lp, ix.contiguous(), torch.full((B, T), -3.0, device=dev)


def assert_beam_records(got, want, what):
    """(final, emits) of the scan: every record exactly equal, the final
    scores within 1e-4 (expf/log1pf of the card against PyTorch's).  Returns
    the largest score difference."""
    import torch
    (final, em), (final_p, em_p) = got, want
    for n in em_p:
        if not torch.equal(em[n], em_p[n]):
            raise AssertionError(f'K2 {what}: record {n} differs from the '
                                 f'plain scan')
    if not torch.equal(final['plen'], final_p['plen']):
        raise AssertionError(f'K2 {what}: plen differs')
    if not em_p['wval'].numel():
        return 0.0
    err = max(float((final[n] - final_p[n]).abs().max())
              for n in ('s', 'ns', 'v_s', 'v_ns'))
    if not err <= 1e-4:
        raise AssertionError(f'K2 {what}: final scores differ by {err}')
    return err


def checked_beam_kernels(errs, what, routes):
    """Module attributes to swap into ops.beam_scan: the two wrappers, each
    holding its kernel to the plain version on the very arguments the search
    passes (every record, prefix and time exactly).  The scan's score error
    is appended to `errs`, and to `routes` whether the walk built its
    outputs in shared memory."""
    import torch
    from reverb_tpu_torch.ops import beam_scan as bs
    fwd, bt = bs.beam_scan_forward, bs.beam_backtrace

    def forward(*args):
        got = fwd(*args)
        errs.append(assert_beam_records(
            got, bs.beam_scan_forward_plain(*args), what))
        return got

    def backtrace(*args):
        T, _, K = args[0]['pfx_parent'].shape
        routes.append(bs.backtrace_launch_plan(T, K, args[3])[2])
        got = bt(*args)
        want = bs.beam_backtrace_plain(*args)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f'K3 {what}: output differs from the plain '
                                 f'backtrace')
        return got
    return {(bs, 'beam_scan_forward'): forward,
            (bs, 'beam_backtrace'): backtrace}


def check_beam(dev, seed):
    """K2+K3 against the plain beam at B=8, T=512, K=K2=10, dense and with
    blank-skip 0.95: prefixes, plens and times exactly equal, scores within
    1e-4; then each of BEAM_CASES with every record, prefix and time held
    exactly at the kernels' own arguments.  Times each kernel against its
    plain version (dense shapes) and checks the wrappers' launch plans
    against the library's."""
    import torch
    from reverb_tpu_torch import _build
    from reverb_tpu_torch.decode import prefix_beam as pb
    from reverb_tpu_torch.ops import beam_scan as bs
    lib = _build.load()
    for T, K, K2, L in ((512, 10, 10, 256), (2048, 10, 10, 2048),
                        (4096, 16, 7, 4096), (1, 4, 4, 1), (150, 10, 10, 150)):
        chunk, smem = bs.scan_launch_plan(T, K, K2)
        if lib.reverb_beam_scan_smem_bytes(chunk) != smem:
            raise AssertionError(f'K2 plan at T={T}: wrapper {smem} bytes, '
                                 f'library '
                                 f'{lib.reverb_beam_scan_smem_bytes(chunk)}')
        chunk, smem, on_chip = bs.backtrace_launch_plan(T, K, L)
        want = lib.reverb_beam_backtrace_smem_bytes(chunk, K, L, int(on_chip))
        if want != smem or smem > bs.SMEM_MAX:
            raise AssertionError(f'K3 plan at T={T}, K={K}, L={L}: wrapper '
                                 f'{smem} bytes, library {want}')
    B, T, K = 8, 512, 10
    lp, ix, blank = peaky_topk(dev, seed)
    lens = torch.tensor([512, 480, 400, 512, 1, 256, 100, 512], device=dev)
    kernels = (bs.beam_scan_forward, bs.beam_backtrace)
    plain = (bs.beam_scan_forward_plain, bs.beam_backtrace_plain)
    errs = []
    for th in (0.0, 0.95):
        cap = T // 2 if th > 0 else 0
        got = pb.ctc_prefix_beam_search_device_topk(lp, ix, blank, lens, K,
                                                    0, 256, th, cap)
        bs.beam_scan_forward, bs.beam_backtrace = plain
        try:
            want = pb.ctc_prefix_beam_search_device_topk(lp, ix, blank, lens,
                                                         K, 0, 256, th, cap)
        finally:
            bs.beam_scan_forward, bs.beam_backtrace = kernels
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ('prefixes', 'plens', 'scores',
                                          'times')):
            if w.dtype.is_floating_point:
                err = float((g - w).abs().max())
                errs.append(err)
                if not err <= 1e-4:
                    raise AssertionError(f'beam {name} (th={th}): {err}')
            elif not torch.equal(g, w):
                raise AssertionError(f'beam {name} (th={th}) differ')
        n_tok = int(got[1][:, 0].sum())
        log(f'K2+K3 beam (blank_skip={th}): prefixes/plens/times equal, '
            f'score err {errs[-1]}; best-hyp tokens {n_tok}')

    # the further shapes, each kernel held at the search's own arguments
    for i, (what, cB, cT, cK, cK2, clens, max_tokens, th) in enumerate(
            BEAM_CASES):
        if what.startswith('forced ties'):
            clp, cix, cblank = tied_topk(dev, cB, cT, cK2)
        else:
            clp, cix, cblank = peaky_topk(dev, seed + 1 + i, cB, cT, cK2)
        clens = torch.tensor(clens or [cT] * cB, device=dev)
        cap = cT // 2 if th > 0 else 0
        case_errs, routes = [], []
        with swapped(checked_beam_kernels(case_errs, what, routes)):
            out = pb.ctc_prefix_beam_search_device_topk(
                clp, cix, cblank, clens, cK, 0, max_tokens, th, cap)
        torch.cuda.synchronize()
        if len(case_errs) != 1:
            raise AssertionError(f'beam case {what}: the scan ran '
                                 f'{len(case_errs)} times')
        errs += case_errs
        log(f'K2+K3 case {what}: B={cB} K={cK} K2={cK2} L={out[0].shape[2]} '
            f'— records, prefixes, plens, times equal, score err '
            f'{case_errs[0]:.2e}; outputs '
            f'{"on chip" if routes[0] else "in device memory"}; best-hyp '
            f'tokens '
            f'{int(out[1][:, 0].sum())}')
    # the walk's other route: outputs too large for shared memory
    route_err = check_backtrace_routes(dev, seed)

    # timing at the dense serving shapes
    ts = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(
        B, T).contiguous()
    valid = torch.arange(T, device=dev)[None] < lens[:, None]
    acc = torch.zeros((B, T), dtype=torch.float32, device=dev)
    hs = torch.zeros((B, T), dtype=torch.bool, device=dev)
    fwd_args = (lp, ix, ts, valid, acc, hs, K, 0)
    final, em = bs.beam_scan_forward(*fwd_args)
    fwd_err = max(errs + [route_err, assert_beam_records(
        (final, em), bs.beam_scan_forward_plain(*fwd_args), 'T=512')])
    order = torch.argsort(-pb._log_add(final['s'], final['ns']), dim=-1,
                          stable=True).to(torch.int32)
    sel = torch.gather(~(final['v_s'] > final['v_ns']), 1, order.long())
    bt_args = (em, order, sel, 256)
    pre, tim = bs.beam_backtrace(*bt_args)
    pre_p, tim_p = bs.beam_backtrace_plain(*bt_args)
    if not (torch.equal(pre, pre_p) and torch.equal(tim, tim_p)):
        raise AssertionError('K3 output differs from the plain backtrace')
    t = {'fwd_plain': cuda_time_ms(
             lambda: bs.beam_scan_forward_plain(*fwd_args), 1),
         'bt_plain': cuda_time_ms(
             lambda: bs.beam_backtrace_plain(*bt_args), 1)}
    t['fwd'], t['fwd_dev'] = both_times(
        lambda: bs.beam_scan_forward(*fwd_args), 5, KERNEL_PATTERNS['K2'])
    t['bt'], t['bt_dev'] = both_times(
        lambda: bs.beam_backtrace(*bt_args), 5, KERNEL_PATTERNS['K3'])
    t['fwd_us_frame'] = t['fwd_dev'] * 1e3 / T
    t['bt_us_frame'] = t['bt_dev'] * 1e3 / T
    log(f'K2 beam_scan_forward: kernel {t["fwd"]:.4f} ms per call '
        f'({t["fwd_dev"]:.4f} on the device, {t["fwd_us_frame"]:.3f} us a '
        f'frame), plain {t["fwd_plain"]:.4f} ms; K3 beam_backtrace: kernel '
        f'{t["bt"]:.4f} ms ({t["bt_dev"]:.4f} on the device, '
        f'{t["bt_us_frame"]:.3f} us a frame), plain {t["bt_plain"]:.4f} ms '
        f'(B=8, T=512, K=10)')
    t['fwd_nbytes'] = nbytes(fwd_args, final, em)
    t['bt_nbytes'] = nbytes(bt_args, pre, tim)
    return fwd_err, t


def check_backtrace_routes(dev, seed):
    """K3 where (K, L) does not fit in shared memory beside the record ring
    (K = 16, L = 1400: the outputs are built in device memory), and the
    same records at L = 256 (built on chip): both exactly equal to the plain
    walk.  The records come from K2, held to the plain scan too.  Returns
    the scan's largest final-score difference."""
    import torch
    from reverb_tpu_torch.decode import prefix_beam as pb
    from reverb_tpu_torch.ops import beam_scan as bs
    B, T, K, K2 = 2, 150, 16, 7
    lp, ix, _ = peaky_topk(dev, seed + 50, B, T, K2)
    ts = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(
        B, T).contiguous()
    valid = torch.ones((B, T), dtype=torch.bool, device=dev)
    acc = torch.zeros((B, T), dtype=torch.float32, device=dev)
    hs = torch.zeros((B, T), dtype=torch.bool, device=dev)
    args = (lp, ix, ts, valid, acc, hs, K, 0)
    final, em = bs.beam_scan_forward(*args)
    err = assert_beam_records((final, em), bs.beam_scan_forward_plain(*args),
                              f'T={T}, K={K}')
    order = torch.argsort(-pb._log_add(final['s'], final['ns']), dim=-1,
                          stable=True).to(torch.int32)
    sel = torch.gather(~(final['v_s'] > final['v_ns']), 1, order.long())
    routes = []
    for L in (1400, 256):
        on_chip = bs.backtrace_launch_plan(T, K, L)[2]
        routes.append(on_chip)
        got = bs.beam_backtrace(em, order, sel, L)
        want = bs.beam_backtrace_plain(em, order, sel, L)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(
                f'K3 at T={T}, K={K}, L={L} (outputs '
                f'{"on chip" if on_chip else "in device memory"}) differs '
                f'from the plain backtrace')
    if routes != [False, True]:
        raise AssertionError(f'K3 routes at L=1400, 256: {routes}')
    log(f'K3 routes: B={B} T={T} K={K}: L=1400 built in device memory, L=256 '
        f'on chip; both equal to the plain walk (longest hyp '
        f'{int(final["plen"].max())} tokens)')
    return err


# ------------------------------ phase 5: the slice ------------------------------

def write_units(path: Path):
    """A 10000-entry char-tokenizer symbol table: blank, unk, word-initial
    ('▁'-prefixed) and word-internal pieces, sos/eos last."""
    lines = ['<blank> 0', '<unk> 1']
    for i in range(2, VOCAB - 1):
        lines.append(f'{"▁" if i % 3 == 0 else ""}p{i} {i}')
    lines.append(f'<sos/eos> {VOCAB - 1}')
    path.write_text('\n'.join(lines) + '\n', encoding='utf8')


def write_wav(path: Path, n_samples: int, seed: int, sr: int = 16000):
    """Synthetic speech-like audio: noise and harmonic bursts under a slowly
    varying envelope, int16."""
    rng = np.random.RandomState(seed)
    t = np.arange(n_samples) / sr
    env = np.repeat(rng.rand(n_samples // 1600 + 1), 1600)[:n_samples]
    f0 = np.repeat(rng.uniform(90, 250, n_samples // 3200 + 1),
                   3200)[:n_samples]
    x = (np.sin(2 * np.pi * f0 * t) + 0.5 * np.sin(4 * np.pi * f0 * t)
         + 0.3 * rng.randn(n_samples)) * env * 6000
    with wave.open(str(path), 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.clip(x, -32768, 32767).astype(np.int16).tobytes())


def build_asr(dev, seed, workdir: Path):
    """reverb_large-width ReverbASR in bf16 with seeded random weights and a
    char tokenizer over a generated 10000-entry symbol table."""
    import torch
    from reverb_tpu_torch.text.tokenizer import init_tokenizer
    from reverb_tpu_torch.cli.reverb import ReverbASR
    from reverb_tpu_torch.models import presets
    from reverb_tpu_torch.models.asr_model import ModelConfig, build_model
    configs = presets.reverb_large()
    configs['tokenizer'] = 'char'
    configs['tokenizer_conf'] = {
        'symbol_table_path': str(workdir / 'units.txt')}
    write_units(workdir / 'units.txt')
    cfg = ModelConfig.from_config(configs).with_compute_dtype(torch.bfloat16)
    t0 = time.perf_counter()
    model = build_model(cfg, dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f'model: reverb_large width, {n_params / 1e6:.1f}M params, bf16 '
        f'compute, built in {time.perf_counter() - t0:.2f} s')
    asr = ReverbASR.from_model(configs, model, init_tokenizer(configs))
    return asr


def sharpen_ctc_head(asr, feats):
    """Shape the random CTC head like a trained model's, as bench.py does:
    weight ×8, blank bias raised to the 75th percentile of (best non-blank −
    blank) over a 4-chunk probe batch, so ~75% of frames are blank-top."""
    import torch
    model = asr.model
    lo = model.ctc.ctc_lo
    with torch.no_grad():
        lo.weight.mul_(8.0)
        batch, lens = next(asr.feats_batcher(feats, CHUNK, 4))
        enc, mask = model.forward_encoder(
            batch, torch.from_numpy(lens).to(feats.device),
            torch.tensor([1.0, 0.0], device=feats.device))
        logits = lo(enc).float()[mask[:, 0]]                 # valid frames
        blank = logits[:, model.cfg.blank_id].clone()
        logits[:, model.cfg.blank_id] = -math.inf
        q = torch.quantile(logits.amax(-1) - blank, 0.75)
        lo.bias[model.cfg.blank_id] += q
    return float(q)


def reference_check(asr, feats, dev):
    """One chunk in f32 (TF32 off), kernels against the plain PyTorch
    versions: the encoder output within 1e-3, then the decode tail (CTC
    top-k → beam → rescoring) on the SAME encoder output with identical
    tokens, times and choices and scores within 1e-4.  (Decoded tokens of
    two encoder runs are not compared: with random weights and a ×8 head,
    1e-6 encoder differences flip near-tied hypotheses.)"""
    import torch
    from reverb_tpu_torch.decode import api
    from reverb_tpu_torch.models.asr_model import build_model
    from reverb_tpu_torch.ops import beam_scan as bs
    model = asr.model
    f32 = build_model(model.cfg.with_compute_dtype(torch.float32), dev,
                      state_dict=model.state_dict())
    x = feats[None, :CHUNK]
    lens = torch.tensor([CHUNK], device=dev)
    cat = torch.tensor([1.0, 0.0], device=dev)
    plain = {(bs, 'beam_scan_forward'): bs.beam_scan_forward_plain,
             (bs, 'beam_backtrace'): bs.beam_backtrace_plain,
             **plain_versions()}

    def run(kernels: bool, fn):
        with swapped({} if kernels else plain), torch.inference_mode():
            return fn()

    def encode():
        return api.encode_and_ctc_topk(f32, x, lens, cat, 10)
    enc_k, enc_p = run(True, encode), run(False, encode)
    err = float((enc_k[0] - enc_p[0]).abs().max())
    top1 = float((enc_k[3][..., 0] == enc_p[3][..., 0]).float().mean())
    if not err <= 1e-3:
        raise AssertionError(f'f32 encoder: kernel vs plain err {err}')

    def tail():
        return api._beam_rescore_tail(f32, enc_k[2], enc_k[3], enc_k[4],
                                      enc_k[0], enc_k[1], 10, 0.1, 0.0, 0.0,
                                      256, cat)
    (beam_k, resc_k), (beam_p, resc_p) = run(True, tail), run(False, tail)
    for g, w in zip(beam_k + resc_k, beam_p + resc_p):
        if w.dtype.is_floating_point:
            ok = torch.allclose(g, w, rtol=0, atol=1e-4, equal_nan=True)
        else:
            ok = torch.equal(g, w)
        if not ok:
            raise AssertionError('f32 decode tail: kernels differ from the '
                                 'plain versions')
    log(f'reference: f32 one chunk, kernels vs plain: encoder max abs err '
        f'{err}, CTC top-1 agreement {top1:.4f}; decode tail identical '
        f'({int(beam_k[1][0, 0])} tokens in the best hyp)')

    # the tail that decode takes when a hypothesis outgrows max_hyp_len:
    # the beam with L = T, rescoring fed by its device buffers
    if int(beam_k[1].max()) <= FALLBACK_MAX_HYP_LEN:
        raise AssertionError('no hypothesis longer than the fallback\'s cap')

    def uncapped():
        return api._decode_uncapped(f32, MODES, enc_k[2], enc_k[3], enc_k[4],
                                    enc_k[0], enc_k[1], 10, 0.1, 0.0, 0.0,
                                    cat)
    res_k, res_p = run(True, uncapped), run(False, uncapped)
    n_long = compare_results(res_k, res_p, 1e-4)
    log(f'reference: uncapped decode tail (L = T), kernels vs plain: tokens, '
        f'times and nbest identical, scores within 1e-4 ({n_long} tokens in '
        f'the rescored best hyp)')
    del f32
    torch.cuda.empty_cache()


def compare_results(got, want, tol, ulps: int = 0):
    """{mode: [DecodeResult]} of two decodes: tokens, times, nbest and
    nbest_times exactly equal; score, confidence, token confidences and
    nbest_scores within tol, or within `ulps` f32 spacings of the plain
    value where that is coarser (a sum of 446 decoder log-probs reaches
    -2533, where one f32 step is 2.4e-4).  Returns the first rescored
    result's token count."""
    def close(a, b):
        if a is None or b is None:
            return a is None and b is None
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        step = ulps * np.spacing(np.abs(b).astype(np.float32))
        with np.errstate(invalid='ignore'):       # inf − inf
            return bool(np.all((a == b)
                               | (np.abs(a - b) <= np.maximum(tol, step))))
    if set(got) != set(want):
        raise AssertionError(f'modes {set(got)} != {set(want)}')
    for mode in want:
        if len(got[mode]) != len(want[mode]):
            raise AssertionError(f'{mode}: result counts differ')
        for g, w in zip(got[mode], want[mode]):
            if (g.tokens, g.times, g.nbest, g.nbest_times) != (
                    w.tokens, w.times, w.nbest, w.nbest_times):
                raise AssertionError(f'{mode}: tokens, times or nbest differ')
            if not (close(g.score, w.score)
                    and close(g.confidence, w.confidence)
                    and close(g.tokens_confidence, w.tokens_confidence)
                    and close(g.nbest_scores, w.nbest_scores)):
                raise AssertionError(f'{mode}: scores differ by more than '
                                     f'{tol}')
    return len(want['attention_rescoring'][0].tokens)


# the cap of the long-hypothesis phase: far below a chunk's ~100 tokens
FALLBACK_MAX_HYP_LEN = 8


def run_fallback(asr, wav, ln_calls):
    """The serving entry point with a decode whose max_hyp_len every chunk
    overflows: transcribe_modes must complete through the uncapped tail,
    which runs K2 and K3 a second time on the encoder output it holds.
    Returns (launches, encoder calls, wall seconds)."""
    import functools
    import torch
    from reverb_tpu_torch.cli import reverb as rv
    from reverb_tpu_torch.decode import api
    from reverb_tpu_torch.ops import beam_scan as bs
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    calls, tails = [], []
    decode_fn, tail_fn = rv.decode_modes_fn, api._decode_uncapped

    def decode(*args, **kwargs):
        out = decode_fn(*args, max_hyp_len=FALLBACK_MAX_HYP_LEN, **kwargs)
        calls.append(out)
        return out

    @functools.wraps(tail_fn)
    def tail(*args, **kwargs):
        tails.append(1)
        return tail_fn(*args, **kwargs)
    fa.LAUNCHES = bs.FWD_LAUNCHES = bs.BT_LAUNCHES = ln.LAUNCHES = 0
    ln_calls[0] = 0
    with swapped({(rv, 'decode_modes_fn'): decode,
                  (api, '_decode_uncapped'): tail}):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = asr.transcribe_modes(str(wav), MODES, format='ctm')
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {'K1': fa.LAUNCHES, 'K2': bs.FWD_LAUNCHES,
                'K3': bs.BT_LAUNCHES, 'K5': ln.LAUNCHES}
    n_enc = len(calls)
    layers = asr.model.cfg.encoder.num_blocks
    want = {'K1': layers * n_enc, 'K2': 2 * n_enc, 'K3': 2 * n_enc,
            'K5': ln_calls[0]}
    log(f'long-hypothesis path (max_hyp_len={FALLBACK_MAX_HYP_LEN}): '
        f'launches {launches}, expected {want} ({n_enc} encoder calls, '
        f'{len(tails)} uncapped tails); transcribe_modes wall {wall:.3f} s')
    if launches != want or len(tails) != n_enc or n_enc < 1:
        raise AssertionError('the long-hypothesis path did not run every '
                             'kernel the expected number of times')
    longest = 0
    for res in calls:
        for mode in MODES:
            for r in res[mode]:
                longest = max(longest, *(len(h) for h in
                                         (r.nbest or [r.tokens])))
                scores = [r.score] + list(r.nbest_scores or [])
                if not all(math.isfinite(x) for x in scores):
                    raise AssertionError(f'{mode}: non-finite score')
                if len(r.tokens) != len(r.times):
                    raise AssertionError(f'{mode}: tokens and times differ '
                                         f'in length')
            if mode == 'attention_rescoring' and not all(
                    not r.tokens or (r.nbest and r.nbest[0] == r.tokens)
                    for r in res[mode]):
                raise AssertionError('rescored nbest does not lead with the '
                                     'best hypothesis')
    if longest <= FALLBACK_MAX_HYP_LEN:
        raise AssertionError('no hypothesis longer than the cap came out')
    for mode, ctm in zip(MODES, out):
        if not [row for row in ctm.splitlines() if row.strip()]:
            raise AssertionError(f'{mode}: empty CTM on the long-hypothesis '
                                 f'path')
    log(f'  longest hypothesis {longest} tokens; '
        + '; '.join(f'{m}: {len(c.splitlines())} CTM rows'
                    for m, c in zip(MODES, out)))
    return launches, n_enc, wall


def serving_setup(dev, seed, workdir: Path):
    """The bf16 reverb_large-width ReverbASR with its CTC head sharpened,
    and the synthetic 8-chunk wav with its features: (asr, wav, feats,
    audio seconds)."""
    import torch
    asr = build_asr(dev, seed, workdir)
    n_samples = 400 + 160 * (N_CHUNKS * CHUNK - 1)
    wav = workdir / 'long.wav'
    write_wav(wav, n_samples, seed)
    feats = asr.compute_feats(str(wav))
    if tuple(feats.shape) != (N_CHUNKS * CHUNK, 80) or \
            not torch.isfinite(feats).all():
        raise AssertionError(f'fbank: shape {tuple(feats.shape)}')
    q = sharpen_ctc_head(asr, feats)
    log(f'ctc head: weight x8, blank bias +{q:.3f} (75th percentile)')
    return asr, wav, feats, n_samples / 16000


def run_slice(dev, asr, wav, feats, audio_s):
    import torch
    from reverb_tpu_torch.cli import reverb as rv
    from reverb_tpu_torch.ops import beam_scan as bs
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    reference_check(asr, feats, dev)

    # record the DecodeResults the entry point produces
    captured = []
    decode_fn = rv.decode_modes_fn

    def recording_decode(*args, **kwargs):
        out = decode_fn(*args, **kwargs)
        captured.append(out)
        return out
    rv.decode_modes_fn = recording_decode
    walls, outputs = [], []
    ln_calls, hooks = ln_call_counter(asr.model)
    fa.LAUNCHES = bs.FWD_LAUNCHES = bs.BT_LAUNCHES = ln.LAUNCHES = 0
    try:
        for kwargs in ({}, {'blank_skip_threshold': 0.95}):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outputs.append(asr.transcribe_modes(str(wav), MODES,
                                                format='ctm', **kwargs))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        rv.decode_modes_fn = decode_fn
    launches = {'K1': fa.LAUNCHES, 'K2': bs.FWD_LAUNCHES,
                'K3': bs.BT_LAUNCHES, 'K5': ln.LAUNCHES}
    n_enc = len(captured)              # one encoder pass per decode batch
    layers = asr.model.cfg.encoder.num_blocks
    want = {'K1': layers * n_enc, 'K2': n_enc, 'K3': n_enc,
            'K5': ln_calls[0]}
    ln_main = ln_calls[0]
    try:
        fallback = run_fallback(asr, wav, ln_calls)
    finally:
        for h in hooks:
            h.remove()
    log(f'serving path launches {launches}, expected {want} '
        f'({n_enc} encoder calls x {layers} layers; K5 = LayerNorm calls '
        f'on the path)')
    if ln_main < LN_ENC * n_enc:
        raise AssertionError('fewer LayerNorm calls than the encoder has')
    if launches != want:
        raise AssertionError('the serving path did not run every kernel the '
                             'expected number of times')
    for out in captured:
        for mode in MODES:
            for r in out[mode]:
                scores = [r.score] + list(r.nbest_scores or [])
                if not all(math.isfinite(s) for s in scores):
                    raise AssertionError(f'{mode}: non-finite score')
                if mode == 'attention_rescoring' and not all(
                        math.isfinite(c) and 0 < c <= 1
                        for c in r.tokens_confidence):
                    raise AssertionError('rescoring confidences')
    for out in outputs:
        for mode, ctm in zip(MODES, out):
            rows = [ln for ln in ctm.splitlines() if ln.strip()]
            if not rows:
                raise AssertionError(f'{mode}: empty CTM')
            for ln in rows:
                f = ln.split()
                if len(f) != 6 or f[0] != wav.name or \
                        not all(math.isfinite(float(x))
                                for x in (f[2], f[3], f[5])):
                    raise AssertionError(f'{mode}: bad CTM row {ln!r}')
        log('  ' + '; '.join(f'{m}: {len(c.splitlines())} CTM rows, first '
                            f'{c.splitlines()[0][:100]!r}'
                            for m, c in zip(MODES, out)))
    log(f'slice: {audio_s:.2f} s of audio; transcribe_modes wall '
        f'{walls[0]:.3f} s (defaults, first call), {walls[1]:.3f} s '
        f'(blank_skip 0.95); xRT of the second call {audio_s / walls[1]:.1f}')
    return launches, walls, audio_s, fallback



# ------------------------------ phase 9: every decode mode ------------------------------

CLI_MODES = ['attention', 'ctc_greedy_search', 'ctc_prefix_beam_search',
             'attention_rescoring', 'joint_decoding',
             'onmt_attention_decoding']


def modes_reference_check(asr, feats, dev):
    """One chunk in f32 (TF32 off): the six CLI modes decode the SAME
    encoder output with the kernels and with their plain versions (K2/K3
    in the prefix beam, K5 in every decoder LayerNorm), and joint_decoding
    once more at ctc_weight 0.5: tokens, times and nbest identical, scores
    within 1e-4 or one f32 step of the value; greedy, the prefix beam and
    joint at 0.5 must emit tokens."""
    import torch
    from reverb_tpu_torch.decode import api
    from reverb_tpu_torch.models.asr_model import build_model
    from reverb_tpu_torch.ops import beam_scan as bs
    f32 = build_model(asr.model.cfg.with_compute_dtype(torch.float32), dev,
                      state_dict=asr.model.state_dict())
    x = feats[None, :CHUNK]
    lens = torch.tensor([CHUNK], device=dev)
    cat = torch.tensor([1.0, 0.0], device=dev)
    with torch.inference_mode():
        encoded = f32.forward_encoder(x, lens, cat)
    plain = {(bs, 'beam_scan_forward'): bs.beam_scan_forward_plain,
             (bs, 'beam_backtrace'): bs.beam_backtrace_plain,
             **plain_versions()}

    def run(kernels: bool, modes, ctc_weight: float):
        table = {(f32, 'forward_encoder'): lambda *a, **k: encoded,
                 **({} if kernels else plain)}
        with swapped(table):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = api.decode(f32, modes, x, lens, beam_size=10,
                             ctc_weight=ctc_weight, cat_embs=cat)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0
    (got, t_k), (want, t_p) = (run(True, CLI_MODES, 0.1),
                               run(False, CLI_MODES, 0.1))
    # at the CLI's ctc_weight 0.1 the random decoder holds joint_decoding
    # to the empty prefix; at 0.5 it extends prefixes, so its extension
    # path and its decoder steps (K5) are held to the plain versions too
    joint = 'joint_decoding at ctc_weight 0.5'
    got[joint] = run(True, ['joint_decoding'], 0.5)[0]['joint_decoding']
    want[joint] = run(False, ['joint_decoding'], 0.5)[0]['joint_decoding']
    n_tok = {m: len(want[m][0].tokens) for m in want}
    diff = {m: max(abs(g.score - w.score) for g, w in zip(got[m], want[m]))
            for m in want}
    log(f'modes reference: tokens of the best hyp {n_tok}; score |kernels '
        f'- plain| {diff}')
    compare_results(got, want, 1e-4, ulps=1)
    for m in ('ctc_greedy_search', 'ctc_prefix_beam_search', joint):
        if not n_tok[m]:
            raise AssertionError(f'f32 modes: {m} emitted no tokens '
                                 f'({n_tok})')
    log(f'modes reference: f32 one chunk, six modes on one encoder output, '
        f'kernels vs plain: tokens, times and nbest identical, scores within '
        f'1e-4 or one f32 step; {t_k:.3f} s with the kernels, {t_p:.3f} s '
        f'plain')
    del f32
    torch.cuda.empty_cache()


def transcribe_s(asr, wav, modes) -> tuple:
    """(seconds, outputs) of one transcribe_modes call, synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = asr.transcribe_modes(str(wav), modes, format='ctm')
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def run_modes(dev, asr, wav, feats, audio_s):
    """The six CLI modes at reverb_large width: the f32 reference check,
    then the bf16 `transcribe_modes` call with all six on the 8-chunk
    wav (after a warm-up call) with its launch counts asserted, then each
    mode alone.  Returns (launches, encoder calls, seconds of the six-mode
    call, {mode: seconds alone})."""
    from reverb_tpu_torch.cli import reverb as rv
    from reverb_tpu_torch.ops import beam_scan as bs
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    modes_reference_check(asr, feats, dev)
    warm, _ = transcribe_s(asr, wav, CLI_MODES)
    captured = []
    decode_fn = rv.decode_modes_fn

    def recording_decode(*args, **kwargs):
        out = decode_fn(*args, **kwargs)
        captured.append(out)
        return out
    ln_calls, hooks = ln_call_counter(asr.model)
    fa.LAUNCHES = bs.FWD_LAUNCHES = bs.BT_LAUNCHES = ln.LAUNCHES = 0
    try:
        with swapped({(rv, 'decode_modes_fn'): recording_decode}):
            wall, outs = transcribe_s(asr, wav, CLI_MODES)
    finally:
        for h in hooks:
            h.remove()
    launches = {'K1': fa.LAUNCHES, 'K2': bs.FWD_LAUNCHES,
                'K3': bs.BT_LAUNCHES, 'K5': ln.LAUNCHES}
    n_enc = len(captured)
    layers = asr.model.cfg.encoder.num_blocks
    # joint_decoding in the set: the prefix beam runs once per encoder call
    # over the dense table, and rescoring reuses its nbest
    want = {'K1': layers * n_enc, 'K2': n_enc, 'K3': n_enc,
            'K5': ln_calls[0]}
    log(f'six-mode path launches {launches}, expected {want} ({n_enc} '
        f'encoder calls; K5 = LayerNorm calls on the path, encoder and '
        f'decoder steps)')
    if launches != want or n_enc < 1 or ln_calls[0] <= LN_ENC * n_enc:
        raise AssertionError('the six-mode path did not run every kernel '
                             'the expected number of times')
    for out in captured:
        for mode in CLI_MODES:
            for r in out[mode]:
                scores = [r.score] + list(r.nbest_scores or [])
                if not all(math.isfinite(x) for x in scores):
                    raise AssertionError(f'{mode}: non-finite score')
                if r.times is not None and len(r.times) != len(r.tokens):
                    raise AssertionError(f'{mode}: tokens and times differ '
                                         f'in length')
    for mode, ctm in zip(CLI_MODES, outs):
        for row in (r for r in ctm.splitlines() if r.strip()):
            f = row.split()
            if len(f) != 6 or f[0] != wav.name or not all(
                    math.isfinite(float(v)) for v in (f[2], f[3], f[5])):
                raise AssertionError(f'{mode}: bad CTM row {row!r}')
    rows = {m: len([r for r in c.splitlines() if r.strip()])
            for m, c in zip(CLI_MODES, outs)}
    if not rows['ctc_prefix_beam_search'] or not rows['attention_rescoring']:
        raise AssertionError(f'empty CTM on the six-mode path: {rows}')
    alone = {m: transcribe_s(asr, wav, [m])[0] for m in CLI_MODES}
    log(f'modes: {audio_s:.2f} s of audio in {N_CHUNKS} chunks, bf16; '
        f'six-mode transcribe_modes {wall:.3f} s (warm-up call {warm:.3f} '
        f's); CTM rows {rows}')
    log('modes: each mode alone (s per call): '
        + ', '.join(f'{m} {t:.3f}' for m, t in alone.items())
        + f'; on {smi_line()}')
    return launches, n_enc, wall, alone


# ------------------------------ shared helpers ------------------------------

class swapped:
    """Context manager: set module attributes {(module, name): value} for
    its body, restore them after."""

    def __init__(self, table):
        self.table = table
        self.saved = {}

    def __enter__(self):
        for (mod, name), val in self.table.items():
            self.saved[(mod, name)] = getattr(mod, name)
            setattr(mod, name, val)
        return self

    def __exit__(self, *exc):
        for (mod, name), val in self.saved.items():
            setattr(mod, name, val)
        return False


def plain_versions():
    """The plain versions of K1/K4 (autograd through the plain attention)
    and K5/K6, as module attributes to swap in."""
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    return {(fa, 'rel_pos_attention'): fa.rel_pos_attention_plain,
            (ln, 'layer_norm_fwd'): ln.layer_norm_plain,
            (ln, 'layer_norm_bwd'): ln.layer_norm_bwd_plain}


def ln_call_counter(model):
    """Forward hooks counting the model's LayerNorm calls on CUDA inputs
    of a shape K5 takes.  Returns ([count], hooks)."""
    from reverb_tpu_torch.models.modules import LayerNorm
    from reverb_tpu_torch.ops import layer_norm as ln
    calls = [0]

    def hook(mod, args, out):
        if args[0].is_cuda and ln.eligible(args[0]):
            calls[0] += 1
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, LayerNorm)]
    return calls, hooks


def rel_err(got, want) -> float:
    """max |got − want| / max |want| (want's scale floored at 1e-30)."""
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


# ------------------------------ phase 6: K1 with mask + K4 ---------------

def check_k1_mask_k4(dev):
    """K1 with the dropout keep-mask and K4 against the plain forward and
    its autograd backward at B·H = 8·16, dk = 64, in each of ATTN_CASES,
    rate 0.1, a mask from a seeded generator; the cotangent is 0 on padded
    query rows.  Each of out, dq, dk, dv, dp, du, dvb within tol of its
    largest value: f32 1e-3 (summation order; D is rowsum(g∘out)), bf16
    5e-2 (the plain backward rounds its intermediate gradients to bf16
    where autograd passes the casts, the kernel only at the end).  Times
    the forward (with mask) and the backward alone at T = 512, every row
    at full length."""
    import torch
    from reverb_tpu_torch.ops import flash_attention as fa
    rate = 0.1
    gen = torch.Generator(device=dev).manual_seed(1)
    names = ('out', 'dq', 'dk', 'dv', 'dp', 'du', 'dvb')
    res = {}
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 5e-2)):
        errs, rels = {}, {}
        for T, lens in ATTN_CASES.items():
            lens = torch.tensor(lens, device=dev)
            q, k, v, pos, u, vb = attn_inputs(dev, gen, dtype, T)
            mask = attn_mask(dev, gen, T, rate)
            row_ok = (torch.arange(T, device=dev)[None, :]
                      < lens.clamp(min=1)[:, None])[:, None, :, None]
            g = (torch.rand(q.shape, device=dev, generator=gen) * 2 - 1).to(
                dtype) * row_ok
            outs = []
            for fn in (fa.rel_pos_attention, fa.rel_pos_attention_plain):
                ins = [t.detach().clone().requires_grad_(True)
                       for t in (q, k, v, pos, u, vb)]
                out = fn(*ins, lens, mask, rate)
                out.backward(g)
                outs.append([out.detach() * row_ok] + [t.grad for t in ins])
            torch.cuda.synchronize()
            errs[f'T{T}'] = {n: float((a.float() - b.float()).abs().max())
                             for n, a, b in zip(names, *outs)}
            rels[f'T{T}'] = {n: rel_err(a, b)
                             for n, a, b in zip(names, *outs)}
            bad = {n: r for n, r in rels[f'T{T}'].items() if not r <= tol}
            if bad:
                raise AssertionError(f'K1 mask/K4 {dtype} T={T}: relative '
                                     f'errors {bad} > {tol}')
            if torch.count_nonzero(outs[0][0][3]):
                raise AssertionError(f'K1 mask T={T}: kv_len 0 row is not 0')
        # timing: every row at full length, T = 512
        T = ATTN_T
        q, k, v, pos, u, vb = attn_inputs(dev, gen, dtype, T)
        mask = attn_mask(dev, gen, T, rate)
        g = (torch.rand(q.shape, device=dev, generator=gen) * 2 - 1).to(dtype)
        full = torch.full((ATTN_B,), T, device=dev)
        t = time_k1_mask_k4(q, k, v, pos, u, vb, full, mask, rate, g)
        for case in errs:
            log(f'K1+mask / K4 {dtype} {case}: max abs err '
                + ', '.join(f'{n}={errs[case][n]:.3e}' for n in names)
                + '; relative ' + ', '.join(f'{n}={rels[case][n]:.2e}'
                                           for n in names) + f' (tol {tol})')
        log(f'K1+mask / K4 {dtype}: all rows at T={T}, rate {rate}: K1+mask '
            f'{t["fwd"]:.4f} ms per call, {t["fwd_dev"]:.4f} on the device '
            f'(plain {t["fwd_plain"]:.4f}), K4 {t["bwd"]:.4f} ms per call, '
            f'{t["bwd_dev"]:.4f} on the device (plain backward '
            f'{t["bwd_plain"]:.4f})')
        o = torch.empty_like(q)
        res[dtype] = dict(
            errs={n: max(e[n] for e in errs.values()) for n in names},
            errs_by_case=errs, **t,
            fwd_nbytes=nbytes(q, k, v, pos, u, vb, full, mask, o),
            # inputs with out, g and lse; dq dk dv dp du dvb like the inputs
            bwd_nbytes=2 * nbytes(q, k, v, pos, u, vb)
            + nbytes(full, mask, o, g) + ATTN_B * ATTN_H * T * 4)
        torch.cuda.empty_cache()
    return res


def attn_mask(dev, gen, T, rate):
    """A (B, H, T, T) int8 keep-mask with keep probability 1 − rate."""
    import torch
    return (torch.rand(ATTN_B, ATTN_H, T, T, device=dev, generator=gen)
            < 1 - rate).to(torch.int8)


def time_k1_mask_k4(q, k, v, pos, u, vb, lens, mask, rate, g):
    """ms per call and device-alone ms of K1 with the keep-mask and of K4
    alone (the training path's pair), and per-call ms of their plain
    versions, on the same inputs."""
    import torch
    from reverb_tpu_torch.ops import flash_attention as fa
    args = (q, k, v, pos, u, vb, lens, mask, rate)
    t = {'fwd_plain': cuda_time_ms(
        lambda: fa.rel_pos_attention_plain(*args), 10)}
    t['fwd'], t['fwd_dev'] = both_times(
        lambda: fa.rel_pos_attention(*args), 10, KERNEL_PATTERNS['K1'])
    p = pos[0]
    uc, vbc = u.to(q.dtype).contiguous(), vb.to(q.dtype).contiguous()
    lens32 = lens.to(torch.int32)
    o, lse = fa._k1(q, k, v, p, uc, vbc, lens32, mask, rate, True)
    t['bwd'], t['bwd_dev'] = both_times(
        lambda: fa._k4(q, k, v, p, uc, vbc, lens32, mask, rate, o, lse, g),
        10, KERNEL_PATTERNS['K4'])
    ins = [x.detach().clone().requires_grad_(True)
           for x in (q, k, v, pos, u, vb)]
    out_p = fa.rel_pos_attention_plain(*ins, lens, mask, rate)
    t['bwd_plain'] = cuda_time_ms(lambda: torch.autograd.grad(
        out_p, ins, g, retain_graph=True), 10)
    return t


# ------------------------------ phase 7: K5 + K6 -------------------------

# row counts of the checks: one row, fewer rows than the grid has warps, and
# the encoder's 8·512 + 1 (also the timed shape); width as reverb_large
LN_ROWS, LN_C = (1, 640, 4097), 1024


def ln_inputs(dev, gen, N, dtype):
    """x (N, C) of mean 0.5 and scale 2, w in [0.5, 1.5), b and the
    cotangent normal; x and the cotangent in dtype, w and b f32."""
    import torch
    C = LN_C
    x = (torch.randn(N, C, device=dev, generator=gen) * 2 + 0.5).to(dtype)
    w = torch.rand(C, device=dev, generator=gen) + 0.5
    b = torch.randn(C, device=dev, generator=gen)
    gy = torch.randn(N, C, device=dev, generator=gen).to(dtype)
    return x, w, b, gy


def time_ln(x, w, b, gy, ln=None):
    """ms per call (over 100 calls: the host's share varies) and
    device-alone ms of K5 and of K6 (eps 1e-5), through the wrapper module
    `ln` (the package's by default)."""
    if ln is None:
        from reverb_tpu_torch.ops import layer_norm as ln
    t = {'fwd': cuda_time_ms(lambda: ln.layer_norm_fwd(x, w, b, 1e-5), 100),
         'fwd_dev': device_time_ms(lambda: ln.layer_norm_fwd(x, w, b, 1e-5),
                                   20, KERNEL_PATTERNS['K5']),
         'bwd': cuda_time_ms(lambda: ln.layer_norm_bwd(x, w, gy, 1e-5), 100),
         'bwd_dev': device_time_ms(lambda: ln.layer_norm_bwd(x, w, gy, 1e-5),
                                   20, KERNEL_PATTERNS['K6'])}
    return t


def check_ln(dev):
    """K5/K6 against the plain versions on (N, 1024) for N in LN_ROWS —
    one row, a grid with more warps than rows, a ragged 4097 — in bf16 and
    f32, eps 1e-5 and 1e-12: y and dx within tol of their largest value,
    dw/db (f32 sums over the rows) too; f32 1e-4, bf16 2e-2 (one bf16 ulp
    where the rounding points differ).  The wrapper's launch plan must take
    the library's rows per block.  Times both at N = 4097, per call and on
    the device alone, beside F.layer_norm and its backward."""
    import torch
    import torch.nn.functional as F
    from reverb_tpu_torch import _build
    from reverb_tpu_torch.ops import layer_norm as ln
    lib = _build.load()
    for C in (128, 1024, 2048, 3072, 8192):
        if lib.reverb_layer_norm_rows_per_block(C) != ln.rows_per_block(C):
            raise AssertionError(f'K6 rows per block at C={C}: library '
                                 f'{lib.reverb_layer_norm_rows_per_block(C)}'
                                 f', wrapper {ln.rows_per_block(C)}')
    gen = torch.Generator(device=dev).manual_seed(2)
    C = LN_C
    res = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        errs = {}
        for N in LN_ROWS:
            x, w, b, gy = ln_inputs(dev, gen, N, dtype)
            for eps in (1e-5, 1e-12):
                got = (ln.layer_norm_fwd(x, w, b, eps),
                       *ln.layer_norm_bwd(x, w, gy, eps))
                want = (ln.layer_norm_plain(x, w, b, eps),
                        *ln.layer_norm_bwd_plain(x, w, gy, eps))
                torch.cuda.synchronize()
                for n, a, c in zip(('y', 'dx', 'dw', 'db'), got, want):
                    r = rel_err(a, c)
                    if not r <= tol:
                        raise AssertionError(
                            f'K5/K6 {dtype} N={N} eps {eps}: {n} relative '
                            f'error {r} > {tol}')
                    errs[n] = max(errs.get(n, 0.0),
                                  float((a.float() - c.float()).abs().max()))
        # timed at the last (the encoder's) row count
        N = x.shape[0]
        t = time_ln(x, w, b, gy)
        t['fwd_plain'] = cuda_time_ms(
            lambda: ln.layer_norm_plain(x, w, b, 1e-5), 20)
        t['bwd_plain'] = cuda_time_ms(
            lambda: ln.layer_norm_bwd_plain(x, w, gy, 1e-5), 20)
        # the library yardstick: F.layer_norm and its autograd backward
        wl, bl = w.to(dtype), b.to(dtype)
        t['fwd_library'], t['fwd_library_dev'] = both_times(
            lambda: F.layer_norm(x, (C,), wl, bl, 1e-5), 20)
        ins = [a.detach().requires_grad_(True) for a in (x, wl, bl)]
        y = F.layer_norm(ins[0], (C,), ins[1], ins[2], 1e-5)
        t['bwd_library'], t['bwd_library_dev'] = both_times(
            lambda: torch.autograd.grad(y, ins, gy, retain_graph=True), 20)
        del y, ins
        t['fwd_nbytes'] = nbytes(x, w, b, x)           # y like x
        t['bwd_nbytes'] = nbytes(x, w, gy, x, w, b)    # dx, dw, db
        log(f'K5/K6 layer_norm {dtype} (N in {LN_ROWS}, C={C}): max abs err '
            + ', '.join(f'{n}={e:.3e}' for n, e in errs.items())
            + f' (tol {tol} of scale); at N={N}: K5 {t["fwd"]:.4f} ms per '
            f'call, {t["fwd_dev"]:.4f} on the device (plain '
            f'{t["fwd_plain"]:.4f}; F.layer_norm {t["fwd_library"]:.4f}, '
            f'{t["fwd_library_dev"]:.4f} on the device), K6 {t["bwd"]:.4f} '
            f'ms per call, {t["bwd_dev"]:.4f} on the device (plain '
            f'{t["bwd_plain"]:.4f}; F.layer_norm backward '
            f'{t["bwd_library"]:.4f}, {t["bwd_library_dev"]:.4f} on the '
            f'device)')
        res[dtype] = dict(errs=errs, t=t)
    return res


# ------------------------------ phase 8: the training slice --------------

def train_batch(dev, B, seed, vocab):
    """B utterances of 1600-2051 feature frames (unit-variance features,
    zero past each length), 40-80 target tokens padded with -1, cat_embs
    [1, 0]."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.randint(1600, CHUNK + 1, (B,), device=dev, generator=gen)
    lens[0] = CHUNK
    feats = torch.randn(B, CHUNK, 80, device=dev, generator=gen)
    feats *= (torch.arange(CHUNK, device=dev)[None, :]
              < lens[:, None])[..., None]
    tlens = torch.randint(40, 81, (B,), device=dev, generator=gen)
    target = torch.randint(1, vocab - 1, (B, 80), device=dev, generator=gen)
    target[torch.arange(80, device=dev)[None, :] >= tlens[:, None]] = -1
    return {'feats': feats, 'feats_lengths': lens, 'target': target,
            'target_lengths': tlens,
            'cat_embs': torch.tensor([[1.0, 0.0]] * B, device=dev)}


def train_model(dev, seed, dtype):
    import torch
    from reverb_tpu_torch.models import presets
    from reverb_tpu_torch.models.asr_model import ModelConfig, build_model
    from reverb_tpu_torch.train.trainer import (TrainConfig,
                                                build_optimizer,
                                                make_train_step)
    configs = presets.reverb_large()
    cfg = ModelConfig.from_config(configs).with_compute_dtype(dtype)
    model = build_model(cfg, dev, generator=torch.Generator(
        device=dev).manual_seed(seed), train=True)
    tc = TrainConfig.from_config(configs)
    opt, _ = build_optimizer(tc, model)
    return model, opt, make_train_step(cfg, opt, tc.accum_grad, tc.grad_clip)


def train_reference_check(dev, seed):
    """reverb_large in f32 (TF32 off), B = 2, dropout on: one loss +
    backward through the kernels and one through the plain versions, with
    generators of the same seed, so the dropout draws match.  The loss
    within 1e-5 relative; every gradient tensor within 1e-3 of its norm
    (norms floored at 1e-4 of the global norm: the rel-pos key biases have
    a gradient that is rounding noise, exactly 0 in exact arithmetic), the
    global gradient within 1e-4."""
    import torch
    from reverb_tpu_torch.models.asr_model import compute_loss
    model, _, _ = train_model(dev, seed, torch.float32)
    batch = train_batch(dev, 2, seed + 1, model.cfg.vocab_size)
    results = []
    for kernels in (True, False):
        with swapped({} if kernels else plain_versions()):
            for p in model.parameters():
                p.grad = None
            out = compute_loss(model, batch,
                               torch.Generator(device=dev).manual_seed(7))
            out['loss'].backward()
            torch.cuda.synchronize()
            results.append((float(out['loss'].detach()),
                            [p.grad.detach().clone() if p.grad is not None
                             else torch.zeros_like(p)
                             for p in model.parameters()]))
    (loss_k, g_k), (loss_p, g_p) = results
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    norm_p = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in g_p])))
    diff = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(a - b) for a, b in zip(g_k, g_p)])))
    worst, worst_name = 0.0, ''
    for (name, _), a, b in zip(model.named_parameters(), g_k, g_p):
        r = float(torch.linalg.vector_norm(a - b)) / max(
            float(torch.linalg.vector_norm(b)), 1e-4 * norm_p)
        if r > worst:
            worst, worst_name = r, name
    log(f'train reference: reverb_large f32, B=2, dropout 0.1, kernels vs '
        f'plain: loss {loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.2e}); '
        f'gradient rel err global {diff / norm_p:.2e}, worst tensor '
        f'{worst:.2e} ({worst_name})')
    if not (loss_rel <= 1e-5 and diff / norm_p <= 1e-4 and worst <= 1e-3):
        raise AssertionError('train reference: kernels differ from the plain '
                             'versions')
    del model, results, g_k, g_p
    torch.cuda.empty_cache()
    return loss_rel, diff / norm_p, worst


def run_train(dev, seed):
    """4 bf16 steps of make_train_step at B = 8, full reverb_large width,
    dropout 0.1, Adam (warmuplr 25000), clip 50."""
    import torch
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    model, opt, step = train_model(dev, seed, torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    batch = train_batch(dev, TRAIN_B, seed + 2, model.cfg.vocab_size)
    audio_s = float(batch['feats_lengths'].sum()) / 100.0
    before = [p.detach().clone() for p in model.parameters()]
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ln_calls, hooks = ln_call_counter(model)
    walls, metrics = [], []
    fa.LAUNCHES = fa.BWD_LAUNCHES = ln.LAUNCHES = ln.BWD_LAUNCHES = 0
    try:
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            metrics.append(step(model, batch, gen))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        for h in hooks:
            h.remove()
    launches = {'K1': fa.LAUNCHES, 'K4': fa.BWD_LAUNCHES,
                'K5': ln.LAUNCHES, 'K6': ln.BWD_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    n = TRAIN_STEPS
    want = {'K1': LAYERS_ENC * n, 'K4': LAYERS_ENC * n,
            'K5': (LN_ENC + LN_DEC) * n, 'K6': (LN_ENC + LN_DEC) * n}
    for i, m in enumerate(metrics):
        log(f'  step {i}: ' + ', '.join(f'{k} {v:.4f}' for k, v in m.items())
            + f'; {walls[i] * 1e3:.1f} ms')
    log(f'training path launches {launches}, expected {want} ({n} steps; '
        f'LayerNorm calls seen {ln_calls[0]})')
    if launches != want or ln_calls[0] != want['K5']:
        raise AssertionError('the training path did not run every kernel '
                             'the expected number of times')
    for m in metrics:
        if not (math.isfinite(m['loss']) and math.isfinite(m['grad_norm'])
                and m['skipped'] == 0.0):
            raise AssertionError(f'train step: {m}')
    changed = sum(int((a != p.detach()).sum())
                  for a, p in zip(before, model.parameters()))
    if changed < n_params // 2:
        raise AssertionError(f'only {changed} of {n_params} parameter '
                             f'elements changed')
    ms = sum(walls[1:]) / (n - 1) * 1e3
    log(f'train: reverb_large {n_params / 1e6:.1f}M params, bf16 with f32 '
        f'master weights, B={TRAIN_B} ({audio_s:.2f} s of audio per step): '
        f'{ms:.1f} ms/step (mean of steps 2-{n}; first step '
        f'{walls[0] * 1e3:.1f} ms), {audio_s / ms * 1e3:.1f} audio-s/s, peak '
        f'memory {peak / 2**30:.2f} GiB; {changed} of {n_params} parameter '
        f'elements changed')
    del model, opt, step, before
    torch.cuda.empty_cache()
    return launches, ms, peak


# kernel families of a training step's profile, first match wins
FAMILIES = [
    ('K1', KERNEL_PATTERNS['K1']),
    ('K4', KERNEL_PATTERNS['K4']),
    ('K5/K6', r'ln_(fwd|bwd|colsum)'),
    ('convolution (cuDNN)', r'conv|implicit_gemm|cudnn|nchwToNhwc'),
    ('GEMM (cuBLAS)', r'nvjet|gemm|cutlass|xmma'),
    ('optimizer (foreach)', r'multi_tensor_apply'),
    ('copies and casts', r'copy_kernel|cat_|CatArray'),
    ('dropout draws', r'distribution_|compare_scalar'),
    ('CTC', r'ctc'),
    ('reductions', r'reduce_kernel'),
    ('other elementwise', r'elementwise'),
]


def profile_train(dev, seed):
    """One bf16 training step (as run_train's) under torch.profiler after
    two warm-up steps and one timed unprofiled step: the device busy union
    over the profiled span, device time by kernel family and the 25 kernels
    with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    model, _, step = train_model(dev, seed, torch.bfloat16)
    batch = train_batch(dev, TRAIN_B, seed + 2, model.cfg.vocab_size)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(model, batch, gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    span = (spans[-1][1] - spans[0][0]) if spans else 0.0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n = by_name.setdefault(e.name, [0.0, 0])
            n[0] += e.time_range.end - e.time_range.start
            n[1] += 1
    log(f'profile: unprofiled steps {", ".join(f"{w:.1f}" for w in walls)} '
        f'ms; profiled step {wall:.1f} ms, device busy {busy / 1e3:.1f} ms '
        f'of a {span / 1e3:.1f} ms device span, {len(spans)} device events')
    fam = {}
    for name, (us, n) in by_name.items():
        key = next((f for f, pat in FAMILIES if re.search(pat, name)),
                   'other')
        fam[key] = fam.get(key, 0.0) + us
    log('profile, device ms by family: ' + ', '.join(
        f'{f} {us / 1e3:.2f}' for f, us in sorted(fam.items(),
                                                  key=lambda kv: -kv[1])))
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:25]:
        log(f'  {us / 1e3:9.3f} ms {n:6d}x  {name[:110]}')
    del model, step
    torch.cuda.empty_cache()


def ptxas_table(text: str) -> dict:
    """{kernel: [registers, spill store bytes, spill load bytes]} from the
    build's `-Xptxas -v` messages; the bf16 attention kernels' names are
    shortened (fwd_kernel<1> is the keep-mask instantiation), the
    LayerNorm kernels' to name<type,template values>, and the beam kernels'
    to name or name<template value>."""
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            short = re.search(r'\d((?:fwd|dkdv|dq)_kernel)ILb([01])E', name)
            lnk = re.search(r'(ln_[a-z_]+?_kernel)(?:I(f|13__nv_bfloat16)'
                            r'((?:L[ib]\d+E)*)E)?', name)
            beam = re.search(r'\d(beam_(?:scan|backtrace)_kernel)'
                             r'(?:ILb([01])E)?', name)
            if short:
                name = f'{short.group(1)}<{short.group(2)}>'
            elif beam:
                name = beam.group(1) + (f'<{beam.group(2)}>'
                                        if beam.group(2) else '')
            elif lnk:
                args = [] if lnk.group(2) is None else [
                    'f32' if lnk.group(2) == 'f' else 'bf16',
                    *re.findall(r'L[ib](\d+)E', lnk.group(3))]
                name = lnk.group(1) + (f'<{",".join(args)}>' if args else '')
            cur = out.setdefault(name, [0, 0, 0])
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      ln)
        if m and cur is not None:
            cur[1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r'Used (\d+) registers', ln)
        if m and cur is not None:
            cur[0] = int(m.group(1))
    return out


def ptxas_smem(text: str) -> dict:
    """{mangled kernel name: static shared-memory bytes} from the build's
    `-Xptxas -v` messages (0 where ptxas names none)."""
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = m.group(1)
            out.setdefault(cur, 0)
            continue
        m = re.search(r'(\d+) bytes smem', ln)
        if m and cur is not None:
            out[cur] = int(m.group(1))
    return out


def load_parent_module(parent: Path, rel: str, name: str):
    """The module at parent/rel loaded under `name`, or None when the
    checkout does not hold it."""
    import importlib.util
    src = parent / rel
    if not src.is_file():
        return None
    spec = importlib.util.spec_from_file_location(name, src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the scan lengths of the beam A/B: a dense serving call, and the two a
# call with blank-skip 0.95 launches (the keep cap and its half)
AB_BEAM_T = (512, 256, 128)


def ab_beam_inputs(dev, seed):
    """{T: (scan arguments, plain records, plain finals)} for the beam A/B
    at B = 8, K = K2 = 10: T = 512 dense with ragged lengths; T = 256 and
    128 the first frames of the same utterances compressed with blank-skip
    0.95 (cap 256), as a serving call passes them."""
    import torch
    from reverb_tpu_torch.decode import prefix_beam as pb
    from reverb_tpu_torch.ops import beam_scan as bs
    B, T, K = 8, 512, 10
    lp, ix, blank = peaky_topk(dev, seed)
    lens = torch.tensor([512, 480, 400, 512, 1, 256, 100, 512], device=dev)
    ts = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(
        B, T).contiguous()
    valid = torch.arange(T, device=dev)[None] < lens[:, None]
    acc = torch.zeros((B, T), dtype=torch.float32, device=dev)
    hs = torch.zeros((B, T), dtype=torch.bool, device=dev)
    args = {T: (lp, ix, ts, valid, acc, hs, K, 0)}
    cts, n_keep, cacc, chs, _ = pb._compress_blanks(blank, lens, 0.95, 256)
    gidx = cts.to(torch.int64)[..., None].expand(-1, -1, K)
    g_lp, g_ix = torch.gather(lp, 1, gidx), torch.gather(ix, 1, gidx)
    for Tb in AB_BEAM_T[1:]:
        cvalid = (torch.arange(Tb, device=dev)[None]
                  < torch.clamp(n_keep, max=Tb)[:, None])
        args[Tb] = (g_lp[:, :Tb].contiguous(), g_ix[:, :Tb].contiguous(),
                    cts[:, :Tb].contiguous(), cvalid,
                    cacc[:, :Tb].contiguous(), chs[:, :Tb].contiguous(), K, 0)
    out = {}
    for Tb, a in args.items():
        final, em = bs.beam_scan_forward_plain(*a)
        order = torch.argsort(-pb._log_add(final['s'], final['ns']), dim=-1,
                              stable=True).to(torch.int32)
        sel = torch.gather(~(final['v_s'] > final['v_ns']), 1, order.long())
        out[Tb] = (a, (final, em), (order, sel),
                   bs.beam_backtrace_plain(em, order, sel, 256))
    return out


def ab_beam(mod, inputs):
    """K2 and K3 through the wrapper module `mod` at each T of `inputs`:
    every record, prefix and time held exactly to the plain versions (K3 on
    the plain scan's order, so both sides walk from the same beams), then
    ms per call and on the device alone.  Returns {'k2_T': ..,
    'k2_dev_T': .., 'k3_T': .., 'k3_dev_T': ..}."""
    import torch
    t = {}
    for T, (a, want, (order, sel), bt_want) in inputs.items():
        got = mod.beam_scan_forward(*a)
        assert_beam_records(got, want, f'A/B T={T}')
        em = got[1]
        pre, tim = mod.beam_backtrace(em, order, sel, 256)
        torch.cuda.synchronize()
        if not (torch.equal(pre, bt_want[0]) and torch.equal(tim, bt_want[1])):
            raise AssertionError(f'A/B K3 at T={T} differs from the plain '
                                 f'backtrace')
        t[f'k2_{T}'], t[f'k2_dev_{T}'] = both_times(
            lambda: mod.beam_scan_forward(*a), 10, KERNEL_PATTERNS['K2'])
        t[f'k3_{T}'], t[f'k3_dev_{T}'] = both_times(
            lambda: mod.beam_backtrace(em, order, sel, 256), 10,
            KERNEL_PATTERNS['K3'])
    return t


def ab_parent(dev, parent: Path):
    """A/B of a parent checkout's kernels against this tree's, in one
    process: builds every source of parent/reverb_tpu_torch/csrc into
    _chipwork/ab/ (the package's own build, a separate library handle, with
    the C signatures of the parent's _build.py where the checkout has it)
    and times, in turns old, new, new, old, per call and on the device
    alone: bf16 K1, K1 with the keep-mask and K4 at T = 512 (every row at
    full length) through this tree's wrappers; K5 and K6 at (4097, 1024)
    and K2 and K3 at B = 8, K = 10, T in AB_BEAM_T, each through the
    parent's own wrapper (reverb_tpu_torch/ops/layer_norm.py, beam_scan.py)
    where the checkout has it, so their per-call times compare the host work
    too.  Every side's output is held to the plain version in its turn.
    Prints one {"ab": [...]} line."""
    import torch
    from reverb_tpu_torch import _build
    from reverb_tpu_torch.ops import beam_scan as bs
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    t0 = time.perf_counter()
    # the parent's C entry points may differ from this tree's: its library
    # takes the signatures of its own _build.py, and its K2/K3 and K5/K6 go
    # through its own wrappers
    pkg = parent / 'reverb_tpu_torch'
    old_build = load_parent_module(parent, 'reverb_tpu_torch/_build.py',
                                   'parent_build')
    old = _build.load_from(pkg / 'csrc', ROOT / '_chipwork' / 'ab',
                           old_build._SIGNATURES if old_build else None)
    log(f'A/B: parent library built in {time.perf_counter() - t0:.2f} s')
    new = _build.load()
    old_ln = load_parent_module(parent, 'reverb_tpu_torch/ops/layer_norm.py',
                                'parent_layer_norm')
    old_bs = load_parent_module(parent, 'reverb_tpu_torch/ops/beam_scan.py',
                                'parent_beam_scan')
    log('A/B: the parent\'s K5/K6 through '
        + ('its own' if old_ln else 'this tree\'s') + ' wrapper, its K2/K3 '
        'through ' + ('its own' if old_bs else 'this tree\'s'))
    old_ln, old_bs = old_ln or ln, old_bs or bs
    beam_in = ab_beam_inputs(dev, SEED)
    gen = torch.Generator(device=dev).manual_seed(9)
    T, rate = ATTN_T, 0.1
    q, k, v, pos, u, vb = attn_inputs(dev, gen, torch.bfloat16, T)
    mask = attn_mask(dev, gen, T, rate)
    g = (torch.rand(q.shape, device=dev, generator=gen) * 2 - 1).to(q.dtype)
    full = torch.full((ATTN_B,), T, device=dev)
    x, w, b, gy = ln_inputs(dev, gen, LN_ROWS[-1], torch.bfloat16)
    ln_want = (ln.layer_norm_plain(x, w, b, 1e-5),
               *ln.layer_norm_bwd_plain(x, w, gy, 1e-5))
    rows = []
    for tag in ('old', 'new', 'new', 'old'):
        lib, mod, bmod = (old, old_ln, old_bs) if tag == 'old' else (
            new, ln, bs)
        with swapped({(_build, 'load'): lambda lib=lib: lib}):
            beam_t = ab_beam(bmod, beam_in)
            got = fa.rel_pos_attention(q, k, v, pos, u, vb, full)
            ln_got = (mod.layer_norm_fwd(x, w, b, 1e-5),
                      *mod.layer_norm_bwd(x, w, gy, 1e-5))
            t = {**time_k1_mask_k4(q, k, v, pos, u, vb, full, mask, rate, g),
                 **{f'ln_{n}': ms
                    for n, ms in time_ln(x, w, b, gy, mod).items()}}
            t['k1'], t['k1_dev'] = both_times(
                lambda: fa.rel_pos_attention(q, k, v, pos, u, vb, full), 20,
                KERNEL_PATTERNS['K1'])
        want = fa.rel_pos_attention_plain(q, k, v, pos, u, vb, full)
        t['k1_err'] = float((got.float() - want.float()).abs().max())
        t['ln_rel_err'] = max(rel_err(a, c) for a, c in zip(ln_got, ln_want))
        t['ln_fwd_plain'] = cuda_time_ms(
            lambda: ln.layer_norm_plain(x, w, b, 1e-5), 20)
        t['ln_bwd_plain'] = cuda_time_ms(
            lambda: ln.layer_norm_bwd_plain(x, w, gy, 1e-5), 20)
        t.update(beam_t)
        rows.append({'build': tag, **t})
        log(f'A/B {tag} (ms per call / on the device): K1 {t["k1"]:.4f} / '
            f'{t["k1_dev"]:.4f} (err {t["k1_err"]:.2e}), K1+mask '
            f'{t["fwd"]:.4f} / {t["fwd_dev"]:.4f} (plain '
            f'{t["fwd_plain"]:.4f}), K4 {t["bwd"]:.4f} / {t["bwd_dev"]:.4f} '
            f'(plain {t["bwd_plain"]:.4f}), K5 {t["ln_fwd"]:.4f} / '
            f'{t["ln_fwd_dev"]:.4f} (plain {t["ln_fwd_plain"]:.4f}), K6 '
            f'{t["ln_bwd"]:.4f} / {t["ln_bwd_dev"]:.4f} (plain '
            f'{t["ln_bwd_plain"]:.4f}); K5/K6 relative err '
            f'{t["ln_rel_err"]:.2e}')
        log(f'A/B {tag} beam, B=8 K=10, records/prefixes/times equal to the '
            f'plain versions (ms per call / on the device): '
            + '; '.join(f'T={T}: K2 {t[f"k2_{T}"]:.4f} / '
                        f'{t[f"k2_dev_{T}"]:.4f}, K3 {t[f"k3_{T}"]:.4f} / '
                        f'{t[f"k3_dev_{T}"]:.4f}' for T in AB_BEAM_T))
    print(json.dumps({'ab': rows, 'parent': str(parent)}))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--phases', default=','.join(ALL_PHASES),
                    help='comma list of kernels, serve, train, modes '
                         '(default all; the result lines need all four), or '
                         'beam: the K2/K3 checks alone')
    ap.add_argument('--profile', action='store_true',
                    help='also profile one bf16 training step')
    ap.add_argument('--ab-parent', type=Path, default=None,
                    help='a checkout of the parent commit (its '
                         'reverb_tpu_torch/csrc, _build.py and ops/): also '
                         'time its K1-K6 against this tree\'s (prints an '
                         '"ab" line)')
    args = ap.parse_args()
    phases = set(args.phases.split(','))
    if not (ROOT / 'reverb_tpu_torch' / '_build.py').is_file():
        print('chip_smoke.py: reverb_tpu_torch/ is not beside this script; '
              'run it from a checkout of the repository', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke.py: torch.cuda.is_available() is False',
              file=sys.stderr)
        return 2
    dev = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: device
    smi = smi_line()
    log(f'device: {torch.cuda.get_device_name(0)} ({smi}); '
        f'torch {torch.__version__}, CUDA {torch.version.cuda}')
    # phase 2: build
    from reverb_tpu_torch import _build
    t0 = time.perf_counter()
    _build.load()
    log(f'build: {time.perf_counter() - t0:.2f} s (nvcc '
        f'{_build.build_seconds if _build.build_seconds is not None else 0:.2f}'
        f' s)')
    ptx = ptxas_table(_build.build_log)
    log(f'ptxas: {len(ptx)} kernels, at most '
        f'{max((r[0] for r in ptx.values()), default=0)} registers a thread; '
        f'spills: {[n for n, r in ptx.items() if r[1] or r[2]] or "none"}')
    tc = {n: r for n, r in ptx.items()
          if re.match(r'(fwd|dkdv|dq)_kernel<', n)}
    log('ptxas, bf16 tensor-core kernels (registers, spill stores/loads '
        'bytes): ' + '; '.join(f'{n} {r[0]} ({r[1]}/{r[2]})'
                               for n, r in sorted(tc.items())))
    if len(tc) != 6:
        raise AssertionError('the bf16 tensor-core kernels are missing from '
                             'the build')
    lnk = {n: r for n, r in ptx.items() if n.startswith('ln_')}
    log('ptxas, LayerNorm kernels (registers, spill stores/loads bytes): '
        + '; '.join(f'{n} {r[0]} ({r[1]}/{r[2]})'
                    for n, r in sorted(lnk.items())))
    if not any(n.startswith('ln_fwd_warp') for n in lnk) or \
            not any(n.startswith('ln_bwd_warp') for n in lnk):
        raise AssertionError('the LayerNorm kernels are missing from the '
                             'build')
    beamk = {n: r for n, r in ptx.items() if n.startswith('beam_')}
    smem = {n: b for n, b in ptxas_smem(_build.build_log).items()
            if 'beam_' in n}
    log('ptxas, beam kernels (registers, spill stores/loads bytes): '
        + '; '.join(f'{n} {r[0]} ({r[1]}/{r[2]})'
                    for n, r in sorted(beamk.items()))
        + '; static shared memory bytes '
        + ', '.join(str(b) for _, b in sorted(smem.items())))
    if set(beamk) != {'beam_scan_kernel', 'beam_backtrace_kernel<0>',
                      'beam_backtrace_kernel<1>'}:
        raise AssertionError(f'the beam kernels of the build: {set(beamk)}')
    if args.ab_parent is not None:
        ab_parent(dev, args.ab_parent)
    if 'beam' in phases and 'kernels' not in phases:
        check_beam(dev, SEED)       # a quick first check of K2/K3 alone
    if 'kernels' in phases:
        # phases 3-4, 6-7: kernels against their plain versions
        k1 = check_k1(dev)
        sdpa = sdpa_yardstick(dev)
        fwd_err, bt = check_beam(dev, SEED)
        k4 = check_k1_mask_k4(dev)[torch.bfloat16]
        lnr = check_ln(dev)[torch.bfloat16]
    if phases & {'serve', 'modes'}:
        with tempfile.TemporaryDirectory(prefix='reverb_smoke_') as tmp:
            served = serving_setup(dev, SEED, Path(tmp))
            if 'serve' in phases:
                # phase 5: the serving path
                launches, walls, audio_s, fallback = run_slice(dev, *served)
            if 'modes' in phases:
                # phase 9: the six CLI modes
                modes = run_modes(dev, *served)
            del served
    if 'train' in phases:
        # phase 8: the training path
        train_reference_check(dev, SEED)
        t_launch, step_ms, peak = run_train(dev, SEED)
        if args.profile:
            profile_train(dev, SEED)
    spilled = [n for n, r in {**tc, **lnk, **beamk}.items() if r[1] or r[2]]
    if spilled:
        raise AssertionError(f'kernels spill registers: {spilled}')
    if phases != set(ALL_PHASES):
        log(f'phases {sorted(phases)} passed; no result lines without all '
            f'of {ALL_PHASES}')
        return 1

    kernels = kernel_records(k1, sdpa, fwd_err, bt, k4, lnr, launches,
                             len(walls), t_launch, fallback, modes)
    log(f'slice: second transcribe_modes call {walls[1]:.4f} s for '
        f'{audio_s:.2f} s of audio, xRT {audio_s / walls[1]:.2f}; six-mode '
        f'call {modes[2]:.3f} s; train {step_ms:.1f} ms/step at '
        f'B={TRAIN_B}, peak {peak / 2**30:.2f} GiB; on {smi}')
    print(smi_line())
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def kernel_records(k1, sdpa, fwd_err, bt, k4, lnr, launches, n_calls,
                   t_launch, fallback, modes):
    """The {"kernels": [...]} entries: launches on the three paths (in all,
    per serving call, per training step and per six-mode call; K2/K3 also
    per call of the long-hypothesis path), the error against the plain
    version, kernel / plain / library times in bf16 at the timed shapes,
    and the bound computed from those shapes."""
    import torch
    k1b = k1[torch.bfloat16]
    N, C = LN_ROWS[-1], LN_C
    m_launch = modes[0]
    per = {n: {'serve': launches.get(n, 0) / n_calls,
               'train': t_launch.get(n, 0) / TRAIN_STEPS,
               'six_modes': m_launch.get(n, 0)}
           for n in ('K1', 'K2', 'K3', 'K4', 'K5', 'K6')}
    for n in ('K2', 'K3'):      # the uncapped tail launches them again
        per[n]['serve_long_hyp'] = fallback[0][n] / fallback[1]
    sdpa_call = ('F.scaled_dot_product_attention(cat(q+u, q+v), cat(k, p), '
                 'v, scale=1/sqrt(dk)), every row at full length')

    def rec(name, src, replaces, kid, err, ms, dev_ms, plain_ms, bnd,
            lib_ms, lib_dev_ms, lib_call, **extra):
        return {'name': name, 'route': 'cuda',
                'source': f'reverb_tpu_torch/csrc/{src}',
                'replaces': f'reverb_tpu/ops/{replaces}',
                'launches': (launches.get(kid, 0) + t_launch.get(kid, 0)
                             + m_launch.get(kid, 0)),
                'launches_per_call': per[kid], 'max_abs_err': err,
                'ms': ms, 'device_ms': dev_ms, 'plain_ms': plain_ms,
                'bound_ms': bnd[0], 'bound_by': bnd[1], 'library_ms': lib_ms,
                'library_device_ms': lib_dev_ms, 'library_call': lib_call,
                **extra}
    k1_bound = bound(attn_ops(ATTN_T, False), k1b['nbytes'], 'bf16')
    k1m_bound = bound(attn_ops(ATTN_T, False), k4['fwd_nbytes'], 'bf16')
    drop = sdpa.get('fwd_drop', (None, None, None))
    bwd = sdpa.get('bwd_drop', (None, None, None))
    return [
        rec('rel_pos_attention_fwd', 'rel_pos_attention_bf16.cu',
            'flash_attention.py:108', 'K1',
            max(max(k1b['errs'].values()), k4['errs']['out']),
            k1b['ms'], k1b['device_ms'], k1b['plain_ms'], k1_bound,
            sdpa['fwd'][0], sdpa['fwd'][2], f'{sdpa_call} [{sdpa["fwd"][1]}]',
            source_f32='reverb_tpu_torch/csrc/rel_pos_attention.cu',
            max_abs_err_by_case=k1b['errs'],
            ms_with_mask=k4['fwd'], device_ms_with_mask=k4['fwd_dev'],
            plain_ms_with_mask=k4['fwd_plain'],
            bound_ms_with_mask=k1m_bound[0],
            bound_by_with_mask=k1m_bound[1], library_ms_with_mask=drop[0],
            library_device_ms_with_mask=drop[2],
            library_call_with_mask=f'the same with dropout_p=0.1 (time '
                                   f'only) [{drop[1]}]'),
        rec('beam_scan_forward', 'beam_scan.cu', 'beam_scan.py:33', 'K2',
            fwd_err, bt['fwd'], bt['fwd_dev'], bt['fwd_plain'],
            bound(0, bt['fwd_nbytes'], 'f32'), None, None, 'none',
            us_per_frame=bt['fwd_us_frame']),
        rec('beam_backtrace', 'beam_scan.cu', 'beam_scan.py:137', 'K3', 0.0,
            bt['bt'], bt['bt_dev'], bt['bt_plain'],
            bound(0, bt['bt_nbytes'], 'f32'), None, None, 'none',
            us_per_frame=bt['bt_us_frame']),
        rec('rel_pos_attention_bwd', 'rel_pos_attention_bf16.cu',
            'flash_attention.py:248', 'K4',
            max(v for n, v in k4['errs'].items() if n != 'out'),
            k4['bwd'], k4['bwd_dev'], k4['bwd_plain'],
            bound(attn_ops(ATTN_T, True), k4['bwd_nbytes'], 'bf16'), bwd[0],
            bwd[2], f'torch.autograd.grad through {sdpa_call}, dropout_p=0.1 '
            f'[{bwd[1]}]',
            source_f32='reverb_tpu_torch/csrc/rel_pos_attention.cu',
            max_abs_err_by_case={c: max(v for n, v in e.items() if n != 'out')
                                 for c, e in k4['errs_by_case'].items()}),
        # LayerNorm operations: ~7 f32 operations an element forward, ~10
        # backward; the bytes bound them either way
        rec('layer_norm_fwd', 'layer_norm.cu', 'layer_norm.py:85', 'K5',
            lnr['errs']['y'], lnr['t']['fwd'], lnr['t']['fwd_dev'],
            lnr['t']['fwd_plain'],
            bound(7 * N * C, lnr['t']['fwd_nbytes'], 'f32'),
            lnr['t']['fwd_library'], lnr['t']['fwd_library_dev'],
            'F.layer_norm(x, (C,), w, b, eps)'),
        rec('layer_norm_bwd', 'layer_norm.cu', 'layer_norm.py:96', 'K6',
            max(lnr['errs'][n] for n in ('dx', 'dw', 'db')), lnr['t']['bwd'],
            lnr['t']['bwd_dev'], lnr['t']['bwd_plain'],
            bound(10 * N * C, lnr['t']['bwd_nbytes'], 'f32'),
            lnr['t']['bwd_library'], lnr['t']['bwd_library_dev'],
            'torch.autograd.grad through F.layer_norm(x, (C,), w, b, eps)'),
    ]


if __name__ == '__main__':
    sys.exit(main())
