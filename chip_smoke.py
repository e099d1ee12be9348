#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (reverb_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

    python3 chip_smoke.py --phases kernels      # only the kernel checks

    python3 chip_smoke.py --phases modes        # only the six CLI modes

    python3 chip_smoke.py --phases stream       # only streaming

    python3 chip_smoke.py --phases diar         # only diarization

    python3 chip_smoke.py --phases recipe       # only the dataset path

    python3 chip_smoke.py --phases context,tools   # context biasing; the
                                                    #   alignment tools

    python3 chip_smoke.py --phases int8,export  # int8 serving; bin.export

    python3 chip_smoke.py --profile             # + one profiled train step

    python3 chip_smoke.py --ab-parent DIR       # + K1-K6 of the checkout
                                                #   DIR, timed in turns

Run from the root of a checkout.  It builds the port's CUDA kernels from
reverb_tpu_torch/csrc, holds each kernel to its plain PyTorch version at
the shapes of the paths below (attention also at a ragged T = 333,
LayerNorm also at 1 and 640 rows, the beam also at the shapes of
BEAM_CASES), times each beside its bound and the one PyTorch call that
computes the same function (its library yardstick, which the port never
calls) — per call (CUDA events around back-to-back calls, host work
included) and on the device alone (the profiler's kernel durations) —
then drives four paths on a reverb_large-width model (18-layer LSL
conformer, d=1024, 16 heads, 6+3-layer bitransformer decoder, V=10000)
with seeded random weights:

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
  table) — and each mode alone, timed;
- streaming (chunk 16, 16 left chunks): K2 resumed from a carried beam
  state against its plain version (records and all eight finals exactly,
  B in {1, 8}, T_hop in {1, 16, 33}, peaky and tied inputs); one 8 s
  `StreamingASR` stream in f32 with the kernels and with the plain
  versions (the same encoder outputs decoded: greedy, the carried prefix
  beam and attention_rescoring identical; every 4th hop the carried beam
  equal to the from-scratch beam over the hop log-probs); then in bf16 a
  60 s `StreamingASR` stream fed 0.64 s at a time (ms per hop, xRT) and a
  `MultiStreamASR` pool of 8 slots x 20.5 s, two joining 2 s late and one
  reset midway (ms per step, aggregate xRT) — per hop and per step K2
  once, K5 at every LayerNorm of the chunk encoder, K1 and K3 never — and
  `recognize_wav` with the chunk flags (CTM byte-equal to the call without
  them; a use_dynamic_chunk copy of the config decodes with the chunk mask
  and no K1);

then the diarization path (f32), on a synthetic 30 min corpus of 5
confusable speakers with 20% overlap, by two routes at full width with
seeded random weights — native (`SegmentationConfig()`: SincNet 80 × 251,
2 × BiLSTM-128; `EmbeddingConfig()`: TDNN 512 → 192) and pyannote
(PyanNet: 4 × BiLSTM-128, 7 powerset classes; ResNet34: blocks 3/4/6/3,
32 base channels, 256-d; state_dicts in the released layout):

- diarization: per route a warm-up `Diarizer` call, then a timed call
  (xRT, `last_phases`; launches: K5 4 per embedding tile on the native
  route, no kernel on the pyannote route); the native call once more
  under the plain versions (embeddings within 1e-5, RTTM byte-identical);
  each embedding net on the card against the CPU (within 1e-5: no TF32);
  K5 timed at the call's shape; `bin/infer_diarization` on a 2 min WAV
  with `--model-dir` and with a lightning `.ckpt` (RTTM rows well-formed);

then the dataset path at reverb_large width in bf16, on a synthetic
corpus (64 + 8 `speech_like` WAVs of 8-20.5 s, texts of 20-80 units of the
10000-entry table, CMVN stats from their fbank):

- recipe: `bin.train.main` in-process (dither 0.1, spec_aug, shuffle and
  sort, static batch 8, 4 workers, Adam with warmuplr, clip 50) for 6
  steps with a snapshot and CV every 3 steps, then CV and `epoch_0.npz`
  (CMVN stats inside, finite cv_loss) — K1 = K4 = 18 and K5 = K6 = 120 a
  step, K1 18 and K5 120 a CV batch; ms per step, the wait on the
  dataset iterator, audio-s/s, peak memory; one step of a
  use_dynamic_chunk copy of the config (K1 = K4 = 0: the chunk mask takes
  the masked route; K5 = K6 = 120); then `bin.average_model` over the
  step-3 snapshot and epoch_0, `bin.get_loss` on the CV list (8 finite
  lines; K1 18 and K5 120 an utterance) and `bin.recognize` with the
  serving mode pair (K1 18, K2 = K3 = 1 a batch, plus one of each through
  the uncapped tail; 8 rows a mode); then, in f32 on the epoch_0
  weights, the kernels against their plain versions on the recipe's own
  batches: every K1/K4/K5/K6 call of a loss + backward on the first
  training batch held to its plain version on that call's inputs, the
  loss within 1e-5 and the gradient no further from an f64 run's than
  twice the plain f32 gradient is; the encoder on the CV batch (each
  call, and 1e-3 at the output) and recognize's decode on one encoder
  output (tokens and times identical, scores within 1e-4, as in
  `modes`).

then context biasing and the tools, on the serving model:

- context: K2b (the biased scan) against the plain biased scan at B = 8,
  T = 512, K = 10 on peaky top-k with a graph of 120 phrases of tokens
  from that top-k (records, trie states exactly; scores within 1e-4; full
  length and ragged; the graph changes hypotheses), timed beside K2;
  then two bf16 `transcribe_modes(MODES, format='ctm', context_graph=g)`
  calls on the 164 s wav with a graph of the file's CTC top-k tokens —
  K1 18 and K2b = K3 = 1 per encoder call, K2 never — whose CTM some row
  of the graph changes and which K2b/K3 swapped for their plain versions
  leave byte-equal; then a deep-biasing model (the context adaptor beside
  the encoder): one f32 loss + backward at B = 2 through the kernels and
  the plain versions (loss within 1e-5, gradients as in training), and 3
  bf16 steps at B = 8 with a cv_list batch (K1 = K4 = 18, K5 = K6 = 120 a
  step);
- tools: on f32 copies of the serving weights, `bin.alignment` on 4 WAVs,
  `cli.transcribe --align`, `--context_path` and plain, each equal to the
  same run on the CPU; one POST to `cli.app` served on 127.0.0.1 (port
  0) from a thread; `force_align` at T = 512, timed.

then the rest of training:

- remat: reverb_large in f32 (TF32 off, B = 2, dropout 0.1): the
  gradients with gradient checkpointing off (twice: the run-to-run
  floor), under `full` and under `dots` (within 4 × that floor or 1e-5 of
  each gradient's scale), and every K1/K4/K5/K6 call of a checkpointed
  step held to its plain version; then in bf16 one model from the same
  weights and generator seed: two steps under each policy at B = 8 and
  B = 32 (ms, peak memory; K1 18 / 36 / 18 and K4 18 a step for off /
  full / dots), two steps each with novograd, with Adam's first moment in
  bf16 and with the non-blank-embedding loss on a sharpened CTC head;
  then `bin.train.main` with `dataset_conf.device_feats` on the recipe's
  corpus, as phase recipe runs it (launches asserted);
- diartrain: the native nets at full width, f32: `train_embedding` (400
  steps of 64 single-speaker 2 s crops of a 20 min corpus of 5
  confusable speakers; K5 = K6 = 4 a step, K6 > 0 asserted) and
  `train_segmentation` (10 steps of 8 × 10 s windows with powerset
  labels); the loss before and after; one embedding step with every
  K5/K6 call held to its plain version; the clusters the Diarizer finds
  on a held-out 5 min with the trained and the random embedding net.

then the int8 serving path and the export of the serving subgraphs, on
the serving model:

- int8: `quantize_model_int8` of the bf16 serving model on the card
  (weight_q8 and w_scale bit-equal to the CPU's `quantize_params_int8`
  of the same weights); `_int_mm`'s int32 accumulators equal to an int64
  CPU product at a q projection (4096 × 1024), the decoder output layer
  (N = 10000), 16 rows (padded) and the first subsampling conv on a
  chunk (im2col, K = 9 padded); the serve phase's f32 reference check on
  the int8 model, each int8 site of the plain run fed the kernel run's
  input (`site_forcing`; the encoder within 1e-3, the decode tail's
  tokens, times and choices identical, scores within 1e-4); one bf16
  and one int8 `transcribe_modes` call timed
  in this process after a warm-up each (wall, peak memory; K1 18, K2 =
  K3 = 1, K5 110 asserted on the int8 call); `calibrate_activation_scales`
  on two chunks, then a static-scale call (wall; its tokens beside the
  dynamic call's);
- export: `bin.export` on reverb_large in f32 — `--format pt2` (three
  `torch.export` programs and the manifest, seconds and file sizes),
  each program loaded back and held to the eager module within 1e-4
  (the encoder chunk over 4 chained windows with the caches carried; K5
  91 a chunk and 29 a decoder call inside the loaded programs);
  `scriptability_check`; `recognize_wav --quantize int8` on the same
  checkpoint (launches asserted); then `--format aot` into a fresh
  directory, which a process started with REVERB_KERNEL_DIR set to it
  loads without building.

Each path runs with the launch counters set to 0 just before it and read
just after.  Every phase raises on failure; the exit code is 0 only when
all of them pass.

Output: progress lines, then the card's `nvidia-smi` name and power limit,
then one JSON line {"kernels": [...]} (each kernel's launches on the
paths, its error against the plain version, its time per call and on the
device alone, the plain version's, the library call's per call and on
the device alone, and the bound), and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import gc
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
ALL_PHASES = ('kernels', 'serve', 'train', 'modes', 'stream', 'diar',
              'recipe', 'context', 'tools', 'remat', 'diartrain', 'int8',
              'export')


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
    # K2 is every scan kernel but the biased one (a parent checkout's scan
    # may be no template)
    'K2': r'beam_scan_kernel(?!<true>|<1>|ILb1E)',
    'K2b': r'beam_scan_kernel(<true>|<1>|ILb1E)',
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
    # the integer state exactly (a parent checkout's wrapper of an A/B may
    # return plen alone)
    for n in ('plen', 'last', 'h1', 'h2'):
        if n in final and not torch.equal(final[n], final_p[n]):
            raise AssertionError(f'K2 {what}: final {n} differs')
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

    def forward(*args, **kwargs):
        got = fwd(*args, **kwargs)
        errs.append(assert_beam_records(
            got, bs.beam_scan_forward_plain(*args, **kwargs), what))
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


def speech_like(n_samples: int, seed: int, sr: int = 16000) -> np.ndarray:
    """Synthetic speech-like audio: noise and harmonic bursts under a slowly
    varying envelope, int16."""
    rng = np.random.RandomState(seed)
    t = np.arange(n_samples) / sr
    env = np.repeat(rng.rand(n_samples // 1600 + 1), 1600)[:n_samples]
    f0 = np.repeat(rng.uniform(90, 250, n_samples // 3200 + 1),
                   3200)[:n_samples]
    x = (np.sin(2 * np.pi * f0 * t) + 0.5 * np.sin(4 * np.pi * f0 * t)
         + 0.3 * rng.randn(n_samples)) * env * 6000
    return np.clip(x, -32768, 32767).astype(np.int16)


def write_wav(path: Path, n_samples: int, seed: int, sr: int = 16000):
    """`speech_like` audio as a 16-bit mono WAV."""
    with wave.open(str(path), 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(speech_like(n_samples, seed, sr).tobytes())


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
    if 'attention_rescoring' not in want:
        return 0
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


# ------------------------------ phase 10: streaming ------------------------------

STREAM_CHUNK, STREAM_LEFT = 16, 16   # decoding_chunk_size, num_left_chunks
STREAM_PIECE = 10240                 # samples fed at a time: 0.64 s, one hop
STREAM_REF_S, STREAM_S = 8.0, 60.0   # the f32 reference and the timed stream
POOL_SLOTS, POOL_S, POOL_LATE_S = 8, 20.5, 2.0
RESUME_PREFIX = 40                   # frames scanned before the resumed hop
RESUME_CASES = [(B, T) for B in (1, 8) for T in (1, 16, 33)]
STREAM_MODES = ('ctc_greedy_search', 'ctc_prefix_beam_search',
                'attention_rescoring')


def stream_audio(seconds: float, seed: int) -> np.ndarray:
    """`speech_like` audio as float32 samples in [-1, 1)."""
    return speech_like(int(seconds * 16000), seed).astype(np.float32) / 32768


def launch_counts() -> dict:
    from reverb_tpu_torch.ops import beam_scan as bs
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    return {'K1': fa.LAUNCHES, 'K2': bs.FWD_LAUNCHES, 'K3': bs.BT_LAUNCHES,
            'K5': ln.LAUNCHES}


def zero_launch_counts():
    from reverb_tpu_torch.ops import beam_scan as bs
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    fa.LAUNCHES = bs.FWD_LAUNCHES = bs.BT_LAUNCHES = ln.LAUNCHES = 0
    bs.BIASED_LAUNCHES = 0


def check_beam_resume(dev, seed):
    """K2 resumed from a carried state (the streaming hop) against its plain
    version: at each (B, T_hop) of RESUME_CASES, on peaky and on tied top-k
    inputs (`tied_topk`), a prefix of RESUME_PREFIX frames is scanned (the
    kernel held to the plain scan), then the hop resumes from that state:
    every record and all eight finals exactly equal, and the two halves
    equal to the unsplit plain scan.  Times the resume at B = 1 and 8,
    T_hop = 16, per call and on the device alone, beside the plain version.
    Returns ([case names], {B: times})."""
    import torch
    from reverb_tpu_torch.decode.prefix_beam import STATE_KEYS
    from reverb_tpu_torch.ops import beam_scan as bs
    K = 10

    def args(lp, ix, t0):
        B, T, _ = lp.shape
        ts = (t0 + torch.arange(T, dtype=torch.int32, device=dev))[None]
        return (lp.contiguous(), ix.contiguous(), ts.expand(B, T).contiguous(),
                torch.ones((B, T), dtype=torch.bool, device=dev),
                torch.zeros((B, T), device=dev),
                torch.zeros((B, T), dtype=torch.bool, device=dev), K, 0)

    def exact(got, want, what):
        (f, e), (fp, ep) = got, want
        for n in ep:
            if not torch.equal(e[n], ep[n]):
                raise AssertionError(f'K2 resume {what}: record {n} differs '
                                     f'from the plain scan')
        for n in STATE_KEYS:
            if not torch.equal(f[n], fp[n]):
                raise AssertionError(f'K2 resume {what}: final {n} differs '
                                     f'from the plain scan')
    cases, times = [], {}
    for i, (B, T) in enumerate(RESUME_CASES):
        for tied in (False, True):
            n = RESUME_PREFIX + T
            if tied:
                lp, ix, _ = tied_topk(dev, max(B, 2), n, K)
                lp, ix = lp[:B], ix[:B]
            else:
                lp, ix, _ = peaky_topk(dev, seed + 100 + i, B, n, K)
            what = f'B={B} T_hop={T}{" tied" if tied else ""}'
            pre = args(lp[:, :RESUME_PREFIX], ix[:, :RESUME_PREFIX], 0)
            st_k, st_p = bs.beam_scan_forward(*pre), \
                bs.beam_scan_forward_plain(*pre)
            exact(st_k, st_p, what + ' (prefix)')
            hop = args(lp[:, RESUME_PREFIX:], ix[:, RESUME_PREFIX:],
                       RESUME_PREFIX)
            got = bs.beam_scan_forward(*hop, state=st_k[0])
            want = bs.beam_scan_forward_plain(*hop, state=st_p[0])
            torch.cuda.synchronize()
            exact(got, want, what)
            f_all, e_all = bs.beam_scan_forward_plain(*args(lp, ix, 0))
            exact(got, (f_all, {m: v[RESUME_PREFIX:]
                                for m, v in e_all.items()}),
                  what + ' against the unsplit scan')
            cases.append(what)
            if T == 16 and not tied:
                st = st_k[0]
                ms, dev_ms = both_times(
                    lambda: bs.beam_scan_forward(*hop, state=st), 20,
                    KERNEL_PATTERNS['K2'])
                plain_ms = cuda_time_ms(
                    lambda: bs.beam_scan_forward_plain(*hop, state=st), 1)
                bnd = bound(0, nbytes(hop[:6], st, got), 'f32')
                times[B] = {'ms': ms, 'device_ms': dev_ms,
                            'plain_ms': plain_ms, 'bound_ms': bnd[0],
                            'bound_by': bnd[1]}
    log(f'K2 resume: {len(cases)} cases (B in {{1, 8}}, T_hop in '
        f'{{1, 16, 33}}, peaky and tied, from a {RESUME_PREFIX}-frame '
        f'prefix): records and all eight finals equal to the plain scan and '
        f'to the unsplit scan; T_hop=16: '
        + '; '.join(f'B={b} {t["ms"]:.4f} ms per call, {t["device_ms"]:.4f} '
                    f'on the device, plain {t["plain_ms"]:.2f}'
                    for b, t in times.items()))
    return cases, times


def stream_reference_check(asr, dev, seed):
    """One 8 s stream through StreamingASR in f32 (TF32 off), fed 0.64 s
    at a time, with the kernels and with the plain versions (K2/K3, K5;
    K1 is not on the path).  The plain run computes every hop's encoder
    output itself and is held to the kernel run's within 1e-3, then decodes
    the kernel run's outputs (its caches included), so both runs decode the
    same log-probs: greedy, the carried prefix beam and attention_rescoring
    must match (tokens, times and nbest identical, scores within 1e-4 or
    one f32 step).  At every 4th hop the kernel run's carried beam must
    equal ctc_prefix_beam_search_raw (K2 and K3 from scratch) over the
    concatenated hop log-probs."""
    import torch
    from reverb_tpu_torch.cli.model import StreamingASR
    from reverb_tpu_torch.cli.reverb import ReverbASR
    from reverb_tpu_torch.decode import prefix_beam as pb
    from reverb_tpu_torch.models.asr_model import build_model
    from reverb_tpu_torch.ops import beam_scan as bs
    f32 = build_model(asr.model.cfg.with_compute_dtype(torch.float32), dev,
                      state_dict=asr.model.state_dict())
    asr32 = ReverbASR.from_model(asr.configs, f32, asr.tokenizer)
    audio = stream_audio(STREAM_REF_S, seed + 11)
    plain = {(bs, 'beam_scan_forward'): bs.beam_scan_forward_plain,
             (bs, 'beam_backtrace'): bs.beam_backtrace_plain,
             **plain_versions()}
    enc = f32.encoder
    chunk_fn = enc.forward_chunk
    recorded, replayed, enc_err, checked = [], [0], [0.0], []

    def replay(xs, *a, **k):
        ys, att, cnn = recorded[replayed[0]]
        replayed[0] += 1
        got = chunk_fn(xs, *a, **k)[0]
        enc_err[0] = max(enc_err[0], float((got - ys).abs().max()))
        return ys, att, cnn

    def record(xs, *a, **k):
        out = chunk_fn(xs, *a, **k)
        recorded.append(out)
        return out

    def run(kernels: bool):
        table = {(enc, 'forward_chunk'): record if kernels else replay,
                 **({} if kernels else plain)}
        with swapped(table):
            s = StreamingASR(asr32, STREAM_CHUNK, STREAM_LEFT)
            hop_lp = []
            accept = s._inc_beam.accept

            def keep(lp):
                hop_lp.append(lp)
                accept(lp)
            s._inc_beam.accept = keep
            for i in range(0, len(audio), STREAM_PIECE):
                s.accept_waveform(audio[i:i + STREAM_PIECE])
                n = len(hop_lp)
                if kernels and n and n % 4 == 0 and n not in checked:
                    checked.append(n)
                    lp = torch.cat(hop_lp)[None]
                    want = pb.ctc_prefix_beam_search_raw(
                        lp, torch.tensor([lp.shape[1]], device=dev), 10,
                        f32.cfg.blank_id)[0]
                    compare_results({'ctc_prefix_beam_search': [
                        s._inc_beam.finalize()]},
                        {'ctc_prefix_beam_search': want}, 1e-4)
            torch.cuda.synchronize()
            return {m: [s.decode(m)] for m in STREAM_MODES}, len(hop_lp)
    (got, hops), (want, hops_p) = run(True), run(False)
    if hops != hops_p or not checked or not enc_err[0] <= 1e-3:
        raise AssertionError(f'f32 stream: {hops} / {hops_p} hops, checks at '
                             f'{checked}, encoder err {enc_err[0]}')
    compare_results(got, want, 1e-4, ulps=1)
    n_tok = {m: len(got[m][0].tokens) for m in got}
    if not n_tok['ctc_prefix_beam_search']:
        raise AssertionError(f'f32 stream decoded no tokens: {n_tok}')
    log(f'stream reference: f32 {STREAM_REF_S} s stream, {hops} hops '
        f'(chunk {STREAM_CHUNK}, {STREAM_LEFT} left chunks), kernels vs '
        f'plain: encoder max abs err {enc_err[0]:.2e} per hop; greedy, prefix '
        f'and rescoring identical (tokens {n_tok}); the carried beam equal to '
        f'the from-scratch beam at hops {checked}')
    del f32, asr32, recorded
    torch.cuda.empty_cache()


def check_ctm_rows(ctm: str, name: str, what: str):
    rows = [r for r in ctm.splitlines() if r.strip()]
    for row in rows:
        f = row.split()
        if len(f) != 6 or f[0] != name or not all(
                math.isfinite(float(v)) for v in (f[2], f[3], f[5])):
            raise AssertionError(f'{what}: bad CTM row {row!r}')
    return len(rows)


def check_stream_result(res, what: str):
    scores = [res.score] + list(res.nbest_scores or [])
    if not all(x is None or math.isfinite(x) for x in scores):
        raise AssertionError(f'{what}: non-finite score')
    if res.times is not None and len(res.times) != len(res.tokens):
        raise AssertionError(f'{what}: tokens and times differ in length')


def run_stream_single(asr, seed):
    """StreamingASR in bf16 over a 60 s stream fed 0.64 s at a time:
    ms per hop (p50, p95) and the stream's xRT, with the launches of the
    feeding asserted: per hop K2 once, K3 and K1 never, K5 at every
    LayerNorm call of the chunk encoder."""
    import torch
    from reverb_tpu_torch.cli.model import StreamingASR
    audio = stream_audio(STREAM_S, seed + 12)
    s = StreamingASR(asr, STREAM_CHUNK, STREAM_LEFT)
    s.accept_waveform(audio[:2 * STREAM_PIECE])  # warm-up: one hop
    s.decode('attention_rescoring')
    s.reset()
    ln_calls, hooks = ln_call_counter(asr.model)
    zero_launch_counts()
    per_hop, hops, wall = [], 0, 0.0
    try:
        for i in range(0, len(audio), STREAM_PIECE):
            before = len(s._enc_chunks)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.accept_waveform(audio[i:i + STREAM_PIECE])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            wall += dt
            n = len(s._enc_chunks) - before
            hops += n
            if n:
                per_hop += [dt * 1e3 / n] * n
    finally:
        for h in hooks:
            h.remove()
    launches = launch_counts()
    want = {'K1': 0, 'K2': hops, 'K3': 0, 'K5': ln_calls[0]}
    if launches != want or ln_calls[0] != LN_ENC * hops:
        raise AssertionError(f'stream launches {launches}, expected {want} '
                             f'({hops} hops, {LN_ENC} LayerNorms a hop)')
    t0 = time.perf_counter()
    out = {m: s.decode(m) for m in STREAM_MODES}
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    for m, r in out.items():
        check_stream_result(r, f'stream {m}')
    if not out['ctc_prefix_beam_search'].tokens:
        raise AssertionError('the bf16 stream decoded no tokens')
    held = len(s._pcm), int(s._feat.shape[0])
    if held[0] > STREAM_PIECE + 400 or held[1] > s.window:
        raise AssertionError(f'the stream holds {held} samples, frames')
    pieces = iter(range(0, len(audio), STREAM_PIECE))

    def one_hop():
        i = next(pieces)
        s.accept_waveform(audio[i:i + STREAM_PIECE])
    prof = profile_calls(one_hop, 4)
    log(profile_line('stream hop', prof))
    p50, p95 = np.percentile(per_hop, [50, 95])
    xrt = STREAM_S / wall
    log(f'stream: bf16 {STREAM_S} s fed in {STREAM_PIECE / 16000} s pieces, '
        f'{hops} hops: {p50:.2f} ms per hop (p50), {p95:.2f} (p95), xRT '
        f'{xrt:.1f}; launches {launches}; the three decodes {t_dec:.3f} s '
        f'(tokens {len(out["ctc_prefix_beam_search"].tokens)}); holds '
        f'{held[0]} samples, {held[1]} frames')
    return {'launches': launches, 'hops': hops, 'p50': float(p50),
            'p95': float(p95), 'xrt': xrt, 'profile': prof}


def run_stream_pool(asr, seed):
    """MultiStreamASR in bf16, POOL_SLOTS slots of POOL_S s each fed 0.64 s
    a round, two slots joining POOL_LATE_S late, slot 0 reset midway and
    given a new stream: ms per step() and the aggregate xRT, with the
    launches asserted: per advancing step K2 once, K3 and K1 never, K5 at
    every LayerNorm call of the chunk encoder."""
    import torch
    from reverb_tpu_torch.cli.stream_pool import MultiStreamASR
    audio = [stream_audio(POOL_S, seed + 20 + b) for b in range(POOL_SLOTS)]
    fresh = stream_audio(POOL_S, seed + 40)
    late = {POOL_SLOTS - 2, POOL_SLOTS - 1}
    join = math.ceil(POOL_LATE_S * 16000 / STREAM_PIECE)
    n_pieces = math.ceil(len(audio[0]) / STREAM_PIECE)
    reset_at = n_pieces // 2
    pool = MultiStreamASR(asr, POOL_SLOTS, STREAM_CHUNK, STREAM_LEFT)
    pool.accept_waveform(0, audio[0][:2 * STREAM_PIECE])  # warm-up: a hop
    pool.step()
    pool.reset()
    ln_calls, hooks = ln_call_counter(asr.model)
    zero_launch_counts()
    steps, fed = [], 0
    try:
        torch.cuda.synchronize()
        t_all = time.perf_counter()
        for r in range(n_pieces + join):
            if r == reset_at:
                pool.reset_slot(0)
                audio[0] = fresh
            for b in range(POOL_SLOTS):
                i = r - (join if b in late else 0) - (
                    reset_at if b == 0 and r >= reset_at else 0)
                piece = audio[b][i * STREAM_PIECE:(i + 1) * STREAM_PIECE] \
                    if i >= 0 else audio[b][:0]
                pool.accept_waveform(b, piece)
                fed += len(piece)
            while True:
                t0 = time.perf_counter()
                ready = pool.step()
                torch.cuda.synchronize()
                if not ready.any():
                    break
                steps.append((time.perf_counter() - t0) * 1e3)
        wall = time.perf_counter() - t_all
    finally:
        for h in hooks:
            h.remove()
    launches = launch_counts()
    want = {'K1': 0, 'K2': len(steps), 'K3': 0, 'K5': ln_calls[0]}
    if launches != want or ln_calls[0] != LN_ENC * len(steps):
        raise AssertionError(f'pool launches {launches}, expected {want} '
                             f'({len(steps)} steps)')
    n_tok = []
    for b in range(POOL_SLOTS):
        for m in ('ctc_greedy_search', 'ctc_prefix_beam_search'):
            check_stream_result(pool.decode(b, m), f'pool slot {b} {m}')
        n_tok.append(len(pool.decode(b).tokens))
        smp, frames = pool.buffered(b)
        if smp > STREAM_PIECE + 400 or frames > pool.window:
            raise AssertionError(f'pool slot {b} holds {smp} samples, '
                                 f'{frames} frames')
    if not all(n_tok):
        raise AssertionError(f'pool slots decoded no tokens: {n_tok}')
    audio_s = fed / 16000

    def one_step():
        for b in range(POOL_SLOTS):
            pool.accept_waveform(b, fresh[:STREAM_PIECE])
        pool.step()
    prof = profile_calls(one_step, 2)
    log(profile_line('stream pool step', prof))
    p50, p95 = np.percentile(steps, [50, 95])
    log(f'stream pool: bf16, {POOL_SLOTS} slots x {POOL_S} s (slots '
        f'{sorted(late)} {POOL_LATE_S} s late, slot 0 reset at round '
        f'{reset_at}), {audio_s:.2f} s of audio in {len(steps)} steps: '
        f'{np.mean(steps):.2f} ms per step (p50 {p50:.2f}, p95 {p95:.2f}), '
        f'aggregate xRT {audio_s / wall:.1f}; launches {launches}; tokens '
        f'per slot {n_tok}')
    return {'launches': launches, 'steps': len(steps),
            'ms': float(np.mean(steps)), 'p50': float(p50),
            'p95': float(p95), 'xrt': audio_s / wall, 'profile': prof}


def run_stream_cli(asr, wav, workdir: Path, seed):
    """The CLI's chunk flags: recognize_wav with --decoding_chunk_size 16
    --num_decoding_left_chunks 4 --simulate_streaming on the reverb_large
    model (use_dynamic_chunk false) writes CTM byte-equal to the call
    without them; then a copy of the config with use_dynamic_chunk: true,
    decoded with --decoding_chunk_size 16 on one 2051-frame chunk,
    completes with the chunk mask (K1 never launched)."""
    import copy
    from reverb_tpu_torch.cli import recognize_wav
    from reverb_tpu_torch.cli import reverb as rv
    from reverb_tpu_torch.models.asr_model import ModelConfig
    out = workdir / 'stream_cli'
    base = ['--model', str(workdir), '--modes', *MODES, '--device', 'cuda']
    flags = ['--decoding_chunk_size', '16', '--num_decoding_left_chunks', '4',
             '--simulate_streaming']
    with swapped({(rv, 'load_model'): lambda *a, **k: asr}):
        recognize_wav.main(base + ['--audio_file', str(wav), '--result_dir',
                                   str(out / 'plain')])
        recognize_wav.main(base + ['--audio_file', str(wav), '--result_dir',
                                   str(out / 'chunk')] + flags)
    rows = {}
    for mode in MODES:
        a = (out / 'plain' / mode / f'{wav.stem}.ctm').read_bytes()
        b = (out / 'chunk' / mode / f'{wav.stem}.ctm').read_bytes()
        if a != b or not a:
            raise AssertionError(f'{mode}: CTM with the chunk flags differs '
                                 f'from the CTM without them')
        rows[mode] = check_ctm_rows(a.decode('utf8'), wav.name, mode)
    configs = copy.deepcopy(asr.configs)
    configs['encoder_conf']['use_dynamic_chunk'] = True
    dyn = ModelConfig.from_config(configs).encoder
    if not dyn.use_dynamic_chunk:
        raise AssertionError('use_dynamic_chunk did not reach the encoder')
    one = workdir / 'one_chunk.wav'
    write_wav(one, 400 + 160 * (CHUNK - 1), seed + 13)
    zero_launch_counts()
    with swapped({(rv, 'load_model'): lambda *a, **k: asr,
                  (asr.model.encoder, 'cfg'): dyn}):
        recognize_wav.main(base + ['--audio_file', str(one), '--result_dir',
                                   str(out / 'dynamic'),
                                   '--decoding_chunk_size', '16'])
    launches = launch_counts()
    n_dyn = {m: check_ctm_rows(
        (out / 'dynamic' / m / 'one_chunk.ctm').read_text(encoding='utf8'),
        one.name, m) for m in MODES}
    if launches['K1'] != 0 or launches['K2'] not in (1, 2) or \
            launches['K3'] != launches['K2'] or launches['K5'] < LN_ENC:
        raise AssertionError(f'use_dynamic_chunk decode launches {launches}')
    log(f'stream CLI: recognize_wav with {" ".join(flags)}: CTM byte-equal '
        f'to the call without them ({rows} rows); use_dynamic_chunk: true '
        f'with --decoding_chunk_size 16 on one {CHUNK}-frame chunk: '
        f'launches {launches}, CTM rows {n_dyn}')


def run_stream(dev, asr, wav, feats, audio_s, seed=SEED):
    """The streaming phase: K2's resume entry against its plain version,
    the f32 StreamingASR reference, the timed bf16 StreamingASR and
    MultiStreamASR, and the CLI's chunk flags."""
    t0 = time.perf_counter()
    cases, resume_t = check_beam_resume(dev, seed)
    stream_reference_check(asr, dev, seed)
    single = run_stream_single(asr, seed)
    pool = run_stream_pool(asr, seed)
    with tempfile.TemporaryDirectory(prefix='reverb_stream_') as tmp:
        run_stream_cli(asr, wav, Path(tmp), seed)
    log(f'stream: {single["p50"]:.2f} ms per hop (p50), xRT '
        f'{single["xrt"]:.1f}; pool {pool["ms"]:.2f} ms per step, aggregate '
        f'xRT {pool["xrt"]:.1f}; the phase took '
        f'{time.perf_counter() - t0:.1f} s; on {smi_line()}')
    return {'resume_cases': cases, 'resume': resume_t, 'single': single,
            'pool': pool}


# ------------------------------ phase 11: diarization ------------------------------

DIAR_MIN, DIAR_SPK, DIAR_OVERLAP = 30.0, 5, 0.2   # the corpus
DIAR_CLI_S = 120.0                 # the CLI's WAV: the corpus's first 2 min


def diar_corpus(minutes: float, n_spk: int, seed: int, overlap_frac: float):
    """Synthetic multi-speaker audio (float32 in [-1, 1), 16 kHz) as
    tools/bench_diar.py makes it: n_spk confusable speakers sharing a 220
    Hz fundamental (partials 5% and 4% apart a speaker), 2-6 s turns with
    0.4-1.2 s gaps, amplitude-modulated at a syllable rate over a noise
    floor; with probability overlap_frac a turn starts 1-2 s inside the
    previous one with another speaker (the bench's own test of that,
    `prev_end - t > SR` after the gap, never holds).  Returns (audio,
    turns)."""
    sr = 16000
    rng = np.random.RandomState(seed)
    total = int(minutes * 60 * sr)
    audio = np.zeros(total, np.float32)
    freqs = [(220.0, 495.0 * 1.05 ** i, 990.0 * 1.04 ** i)
             for i in range(n_spk)]
    turns, t, prev_spk, prev_end = [], 0, -1, 0
    while t < total - sr:
        if turns and rng.rand() < overlap_frac:
            t = prev_end - int(rng.uniform(1.0, 2.0) * sr)
            spk = int(rng.choice([s for s in range(n_spk) if s != prev_spk]))
        else:
            spk = int(rng.randint(n_spk))
        dur = min(int(rng.uniform(2.0, 6.0) * sr), total - t)
        tt = np.arange(dur) / sr
        sig = sum(np.sin(2 * np.pi * f * tt) for f in freqs[spk])
        am = 0.6 + 0.4 * np.sin(2 * np.pi * 3.1 * tt + rng.uniform(0, 6.28))
        audio[t:t + dur] += (sig * am * 0.1
                            + rng.randn(dur) * 0.002).astype(np.float32)
        turns.append((t / sr, (t + dur) / sr, spk))
        prev_spk, prev_end = spk, t + dur
        t = prev_end + int(rng.uniform(0.4, 1.2) * sr)
    return audio, turns


def released_random_state(model, seed: int) -> dict:
    """Seeded random values, on the host, for every entry of a PyanNet's or
    ResNet34's state_dict in its released key layout: weights uniform in
    ±sqrt(3 / fan in) (the LSTM's in ±1/sqrt(hidden)), biases and norm
    shifts N(0, 0.1²), norm scales N(1, 0.1²), BatchNorm running means
    N(0, 0.1²) and variances U(0.5, 1.5), ParamSincFB's bands mel-spaced
    as asteroid initializes them, its n_/window_ buffers as they are."""
    import torch
    from reverb_tpu_torch.diar.pyannet import sinc_fb_buffers
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith('num_batches_tracked'):
            out[k] = torch.zeros((), dtype=torch.long)
        elif k.endswith('filterbank.low_hz_') or \
                k.endswith('filterbank.band_hz_'):
            mel = np.linspace(2595 * np.log10(1 + 30 / 700),
                              2595 * np.log10(1 + (8000 - 100) / 700),
                              shape[0] + 1)
            hz = 700 * (10 ** (mel / 2595) - 1)
            val = hz[:-1] if k.endswith('low_hz_') else np.diff(hz)
            out[k] = torch.from_numpy(val.astype(np.float32)).view(shape)
        elif k.endswith('filterbank.n_'):
            out[k] = sinc_fb_buffers()[0]
        elif k.endswith('filterbank.window_'):
            out[k] = sinc_fb_buffers()[1]
        elif k.endswith('running_var'):
            out[k] = torch.rand(shape, generator=g) + 0.5
        elif k.startswith('lstm.'):
            bound = 1 / math.sqrt(shape[0] // 4)
            out[k] = (torch.rand(shape, generator=g) * 2 - 1) * bound
        elif len(shape) > 1:
            bound = math.sqrt(3 / math.prod(shape[1:]))
            out[k] = (torch.rand(shape, generator=g) * 2 - 1) * bound
        elif k.endswith('weight'):
            out[k] = 1 + 0.1 * torch.randn(shape, generator=g)
        else:                      # biases, shifts, running means
            out[k] = 0.1 * torch.randn(shape, generator=g)
    return out


def diar_routes(dev, seed):
    """The two routes' nets at full width with seeded random weights:
    native (SegmentationConfig(): sinc 80 × 251, 2 × BiLSTM-128;
    EmbeddingConfig(): TDNN 512 → 192) and pyannote (PyanNet: 4 ×
    BiLSTM-128, 7 powerset classes; ResNet34: blocks 3/4/6/3, 32 base
    channels, 256-d), the latter loaded from state_dicts in the released
    layout."""
    import torch
    from reverb_tpu_torch.diar import models as dm
    from reverb_tpu_torch.diar import pyannet as dp
    with torch.device('meta'):
        pyan, resnet = dp.PyanNet(), dp.ResNet34()
    return {
        'native': (dm.build_segmentation(
            dm.SegmentationConfig(), dev,
            generator=torch.Generator(device=dev).manual_seed(seed + 50)),
                   dm.build_embedding(
            dm.EmbeddingConfig(), dev,
            generator=torch.Generator(device=dev).manual_seed(seed + 51))),
        'pyannote': (dp.build_pyannet(released_random_state(pyan, seed + 52),
                                      dev),
                     dp.build_resnet34(
                         released_random_state(resnet, seed + 53), dev))}


def diar_speech_share(seg, audio, dev) -> tuple:
    """(share of frames with a speaker active, argmax classes seen) of the
    segmentation net on the corpus's first 16 windows."""
    import torch
    from reverb_tpu_torch.diar.models import powerset_to_multilabel
    rows = torch.from_numpy(np.stack([audio[i * 80000:i * 80000 + 160000]
                                      for i in range(16)])).to(dev)
    with torch.inference_mode():
        logp = seg(rows)
    act = powerset_to_multilabel(torch.exp(logp), seg.max_speakers,
                                 seg.max_simultaneous)
    return (float(act.amax(-1).mean()),
            sorted(set(torch.argmax(logp, -1).flatten().tolist())))


def diar_bias_off_silence(seg, audio, dev, route: str):
    """Where the random weights label every probed frame silent, lower the
    classifier's silence bias below every frame's best speaker class (as
    the serve phase sharpens the random CTC head) and say so."""
    import torch
    share, classes = diar_speech_share(seg, audio, dev)
    if share > 0:
        log(f'diar {route}: random weights label {share:.3f} of the probed '
            f'frames speech (argmax classes {classes}); classifier as drawn')
        return
    rows = torch.from_numpy(np.stack([audio[i * 80000:i * 80000 + 160000]
                                      for i in range(16)])).to(dev)
    with torch.inference_mode():
        logp = seg(rows)
    gap = float((logp[..., 0] - logp[..., 1:].amax(-1)).amax())
    with torch.no_grad():
        seg.classifier.bias[0] -= gap + 1.0
    share, classes = diar_speech_share(seg, audio, dev)
    log(f'diar {route}: random weights labelled every probed frame silent; '
        f'silence bias lowered by {gap + 1.0:.3f}: now {share:.3f} speech '
        f'(argmax classes {classes})')
    if share == 0:
        raise AssertionError(f'diar {route}: still no speech')


def diar_launch_counts() -> dict:
    from reverb_tpu_torch.ops import beam_scan as bs
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    return {'K1': fa.LAUNCHES, 'K2': bs.FWD_LAUNCHES, 'K3': bs.BT_LAUNCHES,
            'K4': fa.BWD_LAUNCHES, 'K5': ln.LAUNCHES, 'K6': ln.BWD_LAUNCHES}


def diar_zero_launch_counts():
    from reverb_tpu_torch.ops import beam_scan as bs
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    fa.LAUNCHES = fa.BWD_LAUNCHES = bs.FWD_LAUNCHES = bs.BT_LAUNCHES = 0
    ln.LAUNCHES = ln.BWD_LAUNCHES = 0


def rttm_text(segments) -> str:
    import io
    from reverb_tpu_torch.diar.pipeline import write_rttm
    f = io.StringIO()
    write_rttm(f, segments, 'corpus')
    return f.getvalue()


def check_rttm_rows(text: str, uri: str, what: str) -> int:
    """Every row `SPEAKER uri 1 start dur <NA> <NA> SPEAKER_nn <NA> <NA>`
    with finite start ≥ 0 and dur > 0; returns the row count."""
    rows = [r for r in text.splitlines() if r.strip()]
    for r in rows:
        f = r.split()
        if len(f) != 10 or f[:3] != ['SPEAKER', uri, '1'] or \
                f[5:7] != ['<NA>', '<NA>'] or f[8:] != ['<NA>', '<NA>'] or \
                not re.fullmatch(r'SPEAKER_\d\d', f[7]) or \
                not (math.isfinite(float(f[3])) and float(f[3]) >= 0
                     and math.isfinite(float(f[4])) and float(f[4]) > 0):
            raise AssertionError(f'{what}: bad RTTM row {r!r}')
    return len(rows)


def diar_call(diar, audio):
    """One timed Diarizer call with the launch counters set to 0 just
    before and read just after: (segments, wall s, launches, embedding
    calls, the first TDNN LayerNorm's input shape or None)."""
    import torch
    calls, shapes = [0], []
    hooks = [diar.embedding.register_forward_hook(
        lambda mod, args, out: calls.__setitem__(0, calls[0] + 1))]
    norms = [m for m in diar.embedding.modules()
             if type(m).__name__ == 'LayerNorm']
    if norms:
        hooks.append(norms[0].register_forward_hook(
            lambda mod, args, out: shapes.append(tuple(args[0].shape))))
    torch.cuda.synchronize()
    diar_zero_launch_counts()
    t0 = time.perf_counter()
    try:
        segs = diar(audio, 16000)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    wall = time.perf_counter() - t0
    launches = diar_launch_counts()
    return segs, wall, launches, calls[0], (shapes[0] if shapes else None)


def check_f32_convolutions(nets, dev):
    """Each route's embedding net on the card against the same net on the
    CPU (f32) on 8 crops of 200 frames: within 1e-5 (the ResNet34 with its
    f32 pin taken away and cuDNN's TF32 on missed by 8.7e-5 on the H100;
    printed beside them, not held)."""
    import copy
    import contextlib
    import torch
    from reverb_tpu_torch.diar import pyannet as dp
    gen = torch.Generator().manual_seed(7)
    feats = torch.randn(8, 200, 80, generator=gen) * 3
    lens = torch.tensor([200, 150, 100, 64, 200, 31, 180, 120])
    errs, cpu = {}, {}
    for route, emb in nets.items():
        with torch.inference_mode():
            card = emb(feats.to(dev), lens.to(dev)).cpu()
            cpu[route] = copy.deepcopy(emb).to('cpu')(feats, lens)
        errs[route] = float((card - cpu[route]).abs().max())
        if not errs[route] <= 1e-5:
            raise AssertionError(f'diar {route}: embedding on the card vs the '
                                 f'CPU {errs[route]} > 1e-5')
    saved = torch.backends.cudnn.allow_tf32
    with swapped({(dp, 'f32_math'): contextlib.nullcontext}):
        torch.backends.cudnn.allow_tf32 = True
        try:
            with torch.inference_mode():
                tf32 = nets['pyannote'](feats.to(dev), lens.to(dev)).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = saved
    errs['pyannote_tf32_unpinned'] = float(
        (tf32 - cpu['pyannote']).abs().max())
    log(f'diar f32: embeddings on the card vs the CPU, max abs '
        + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
        + ' (the last with cuDNN TF32 on and the pin removed)')
    return errs


def time_k5_at(shape, dev):
    """K5 per call and on the device alone at the diarization shape (rows,
    512) f32, beside the plain version, F.layer_norm and the byte bound."""
    import torch
    import torch.nn.functional as F
    from reverb_tpu_torch.ops import layer_norm as ln
    gen = torch.Generator(device=dev).manual_seed(5)
    N, C = shape
    x = torch.randn(N, C, device=dev, generator=gen) * 2 + 0.5
    w = torch.rand(C, device=dev, generator=gen) + 0.5
    b = torch.randn(C, device=dev, generator=gen)
    err = float((ln.layer_norm_fwd(x, w, b, 1e-5)
                 - ln.layer_norm_plain(x, w, b, 1e-5)).abs().max())
    if not err <= 1e-4:
        raise AssertionError(f'K5 at {shape}: max abs err {err}')
    t = {'shape': [N, C], 'max_abs_err': err,
         'ms': cuda_time_ms(lambda: ln.layer_norm_fwd(x, w, b, 1e-5), 20),
         'device_ms': device_time_ms(lambda: ln.layer_norm_fwd(x, w, b, 1e-5),
                                     10, KERNEL_PATTERNS['K5']),
         'plain_ms': cuda_time_ms(lambda: ln.layer_norm_plain(x, w, b, 1e-5),
                                  10)}
    t['library_ms'], t['library_device_ms'] = both_times(
        lambda: F.layer_norm(x, (C,), w, b, 1e-5), 10)
    t['bound_ms'], t['bound_by'] = bound(7 * N * C, nbytes(x, w, b, x), 'f32')
    log(f'K5 at the diarization shape ({N}, {C}) f32: {t["ms"]:.4f} ms per '
        f'call, {t["device_ms"]:.4f} on the device (plain '
        f'{t["plain_ms"]:.4f}; F.layer_norm {t["library_ms"]:.4f}, '
        f'{t["library_device_ms"]:.4f} on the device; bound '
        f'{t["bound_ms"]:.4f} by {t["bound_by"]}); max abs err {err:.3e}')
    return t


def run_diar_cli(nets, audio, workdir: Path):
    """`bin/infer_diarization.main` on a WAV of the corpus's first
    DIAR_CLI_S seconds: with --model-dir (the native route's nets written
    as the JAX package's segmentation.npz / embedding.npz) — the RTTM must
    equal the in-memory Diarizer's on the same samples — and with a
    pyannote-format lightning .ckpt and a wespeaker .pt; every row
    well-formed."""
    import torch
    from reverb_tpu_torch.bin.infer_diarization import main as diarize
    from reverb_tpu_torch.diar.convert import npz_arrays
    from reverb_tpu_torch.diar.pipeline import Diarizer
    n = int(DIAR_CLI_S * 16000)
    pcm = np.clip(np.round(audio[:n] * 32768), -32768, 32767).astype('<i2')
    wav = workdir / 'talk.wav'
    with wave.open(str(wav), 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    seg, emb = nets['native']
    mdir = workdir / 'model'
    mdir.mkdir()
    np.savez(mdir / 'segmentation.npz', **npz_arrays(seg.state_dict()))
    np.savez(mdir / 'embedding.npz', **npz_arrays(emb.state_dict()))
    pseg, pemb = nets['pyannote']
    ckpt, pt = workdir / 'seg.ckpt', workdir / 'emb.pt'
    torch.save({'state_dict': {f'model.{k}': v.cpu() for k, v in
                               pseg.state_dict().items()}}, ckpt)
    torch.save({k: v.cpu() for k, v in pemb.state_dict().items()}, pt)
    rows = {}
    for name, flags in (('model_dir', ['--model-dir', str(mdir)]),
                        ('pyannote', ['--segmentation-ckpt', str(ckpt),
                                      '--embedding-ckpt', str(pt)])):
        out = workdir / name
        t0 = time.perf_counter()
        diarize([str(wav), '--out-dir', str(out)] + flags)
        text = (out / 'talk.rttm').read_text()
        rows[name] = (check_rttm_rows(text, 'talk', f'CLI {name}'),
                      time.perf_counter() - t0)
        if name == 'model_dir':
            direct = Diarizer(seg, emb, device=seg.classifier.weight.device)
            want = rttm_text(direct(pcm.astype(np.float32) / 32768)
                             ).replace('SPEAKER corpus ', 'SPEAKER talk ')
            if text != want:
                raise AssertionError('CLI --model-dir: RTTM differs from the '
                                     'Diarizer on the same weights')
    log('diar CLI on a ' + f'{DIAR_CLI_S:.0f} s WAV: ' + '; '.join(
        f'{k}: {r} RTTM rows in {s:.2f} s' for k, (r, s) in rows.items()))
    return rows


def run_diar(dev, seed=SEED):
    """The diarization phase (f32): both routes at full width on the
    DIAR_MIN-minute corpus — a warm-up call, then a timed call (xRT,
    last_phases, launches: K5 4 per embedding tile on the native route,
    nothing on the pyannote route); the native route once more under the
    plain versions (embeddings within 1e-5, RTTM identical); the
    embedding nets against the CPU (no TF32); K5 timed at the diarization
    shape; the CLI."""
    import torch
    from reverb_tpu_torch.diar.pipeline import Diarizer
    t_phase = time.perf_counter()
    audio, turns = diar_corpus(DIAR_MIN, DIAR_SPK, seed + 60, DIAR_OVERLAP)
    audio_s = len(audio) / 16000
    overlapped = sum(b[0] < a[1] for a, b in zip(turns, turns[1:]))
    nets = diar_routes(dev, seed)
    res = {'audio_s': audio_s}
    for route, (seg, emb) in nets.items():
        diar_bias_off_silence(seg, audio, dev, route)
        diar = Diarizer(seg, emb, device=dev)
        t0 = time.perf_counter()
        diar(audio, 16000)                       # warm-up
        warm = time.perf_counter() - t0
        segs, wall, launches, emb_calls, k5_shape = diar_call(diar, audio)
        n_seg = len(diar.last_embeddings)
        tile = Diarizer._tile_rows(n_seg, Diarizer.EMB_TILE)
        tiles = -(-n_seg // tile)
        if tiles < 1 or emb_calls != tiles:
            raise AssertionError(f'diar {route}: {n_seg} segments, '
                                 f'{emb_calls} embedding calls, {tiles} '
                                 f'tiles')
        want = {k: 0 for k in launches}
        if route == 'native':
            want['K5'] = 4 * tiles
        if launches != want:
            raise AssertionError(f'diar {route}: launches {launches}, '
                                 f'expected {want}')
        text = rttm_text(segs)
        rows = check_rttm_rows(text, 'corpus', f'diar {route}')
        embs = diar.last_embeddings
        if not (np.isfinite(embs).all() and np.allclose(
                np.linalg.norm(embs, axis=1), 1, atol=1e-4)):
            raise AssertionError(f'diar {route}: embeddings not unit norm')
        n_spk = len({s.speaker for s in segs})
        res[route] = {'wall_s': wall, 'warmup_s': warm,
                      'xrt': audio_s / wall, 'phases': diar.last_phases,
                      'launches': launches, 'tiles': tiles,
                      'segments': n_seg, 'rttm_rows': rows,
                      'clusters': n_spk, 'k5_shape': k5_shape}
        log(f'diar {route}: {audio_s:.1f} s corpus ({len(turns)} turns, '
            f'{overlapped} starting inside the one before, {DIAR_SPK} '
            f'speakers): warm-up '
            f'{warm:.3f} s, timed call {wall:.3f} s, xRT '
            f'{audio_s / wall:.1f}; phases {diar.last_phases}; '
            f'{n_seg} local segments in {tiles} embedding tiles '
            f'(K5 input {k5_shape}), {n_spk} clusters, {rows} RTTM rows; '
            f'launches {launches}')
        if route == 'native':
            with swapped(plain_versions()):
                diar_zero_launch_counts()
                plain = diar(audio, 16000)
                if diar_launch_counts()['K5']:
                    raise AssertionError('K5 launched under the plain '
                                         'versions')
            err = float(np.abs(diar.last_embeddings - embs).max())
            if not err <= 1e-5 or rttm_text(plain) != text:
                raise AssertionError(f'diar native: kernels vs plain: '
                                     f'embeddings {err}, RTTM equal '
                                     f'{rttm_text(plain) == text}')
            res['native']['plain_err'] = err
            log(f'diar native: K5 vs the plain LayerNorm on the same call: '
                f'embeddings max abs {err:.3e} (tol 1e-5), RTTM '
                f'byte-identical')
            prof = profile_calls(lambda: diar(audio, 16000), 1)
            res['native']['profile'] = prof
            log(profile_line('diar native call', prof))
    res['f32'] = check_f32_convolutions(
        {r: e for r, (_, e) in nets.items()}, dev)
    res['k5'] = time_k5_at((res['native']['k5_shape'][0]
                            * res['native']['k5_shape'][1],
                            res['native']['k5_shape'][2]), dev)
    with tempfile.TemporaryDirectory(prefix='reverb_diar_') as tmp:
        res['cli'] = run_diar_cli(nets, audio, Path(tmp))
    del nets
    torch.cuda.empty_cache()
    log(f'diar: native xRT {res["native"]["xrt"]:.1f}, pyannote xRT '
        f'{res["pyannote"]["xrt"]:.1f}; the phase took '
        f'{time.perf_counter() - t_phase:.1f} s; on {smi_line()}')
    return res


# ------------------------------ phase 12: the dataset path ------------------------------

RECIPE_TRAIN, RECIPE_CV = 64, 8          # WAVs of 8-20.5 s
RECIPE_STEPS, RECIPE_B, RECIPE_SAVE = 6, 8, 3
RECIPE_MODES = ['ctc_prefix_beam_search', 'attention_rescoring']


def recipe_corpus(workdir: Path, seed: int) -> dict:
    """The corpus of the recipe: RECIPE_TRAIN + RECIPE_CV `speech_like`
    WAVs of 8-20.5 s, raw JSON-line lists with texts of 20-80 random units
    of the 10000-entry table (style verbatim), and a global_cmvn JSON
    computed from the training WAVs' fbank."""
    from reverb_tpu_torch.frontend.fbank import FbankConfig, fbank_numpy
    rng = np.random.RandomState(seed)
    write_units(workdir / 'units.txt')
    units = [line.split()[0] for line in
             (workdir / 'units.txt').read_text(encoding='utf8').splitlines()
             [2:-1]]
    lists = {'train': [], 'cv': []}
    sums, sqs, frames = np.zeros(80), np.zeros(80), 0
    audio_s = {'train': 0.0, 'cv': 0.0}
    for i in range(RECIPE_TRAIN + RECIPE_CV):
        part = 'train' if i < RECIPE_TRAIN else 'cv'
        n = int(rng.uniform(8.0, 20.5) * 16000)
        wav = workdir / f'utt{i:03d}.wav'
        write_wav(wav, n, seed + 100 + i)
        audio_s[part] += n / 16000
        text = ' '.join(rng.choice(units, rng.randint(20, 81)))
        lists[part].append(json.dumps({'key': f'job{i:03d}_utt{i:03d}',
                                       'wav': str(wav), 'txt': text,
                                       'style': 'verbatim'}))
        if part == 'train':
            feat = fbank_numpy(speech_like(n, seed + 100 + i).astype(
                np.float32), FbankConfig()).astype(np.float64)
            sums += feat.sum(0)
            sqs += (feat ** 2).sum(0)
            frames += feat.shape[0]
    for part, lines in lists.items():
        (workdir / f'{part}.list').write_text('\n'.join(lines) + '\n')
    (workdir / 'global_cmvn').write_text(json.dumps({
        'mean_stat': sums.tolist(), 'var_stat': sqs.tolist(),
        'frame_num': frames}))
    return audio_s


def recipe_config(workdir: Path, dynamic_chunk: bool = False,
                  device_feats: bool = False) -> dict:
    """presets.reverb_large() in bf16 with the char tokenizer over the
    generated table, global CMVN, and the dataset_conf of the recipe
    (with `device_feats`, the fbank, dither and SpecAugment in the step)."""
    from reverb_tpu_torch.models import presets
    configs = presets.reverb_large()
    configs.update({
        'dtype': 'bf16', 'tokenizer': 'char',
        'tokenizer_conf': {'symbol_table_path': str(workdir / 'units.txt'),
                           'split_with_space': True},
        'cmvn': 'global_cmvn',
        'cmvn_conf': {'cmvn_file': str(workdir / 'global_cmvn'),
                      'is_json_cmvn': True},
        'snapshot_saving_conf': {'save_interval': RECIPE_SAVE}})
    configs['dataset_conf'].update({
        'fbank_conf': {'num_mel_bins': 80, 'frame_length': 25,
                       'frame_shift': 10, 'dither': 0.1},
        'spec_aug': True, 'shuffle': True, 'sort': True,
        'batch_conf': {'batch_type': 'static', 'batch_size': RECIPE_B},
        'num_workers': 4})
    if dynamic_chunk:
        configs['encoder_conf'] = dict(configs['encoder_conf'],
                                       use_dynamic_chunk=True,
                                       use_dynamic_left_chunk=True)
    if device_feats:
        configs['dataset_conf']['device_feats'] = True
    return configs


def recipe_train(dev, workdir: Path, seed: int,
                 device_feats: bool = False) -> dict:
    """`bin.train.main` in-process: 1 epoch of RECIPE_STEPS steps at B = 8,
    a snapshot with CV at step RECIPE_SAVE, CV and epoch_0 at the end.
    The executor's dataset iterator and step are wrapped to time the wait
    and the step; build_model to count the LayerNorm calls.  With
    `device_feats` the recipe's config computes its features in the step
    (exp_device_feats/)."""
    import gc
    import torch
    from reverb_tpu_torch.bin import train as train_bin
    from reverb_tpu_torch.frontend.cmvn import load_cmvn
    from reverb_tpu_torch.models import asr_model
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    from reverb_tpu_torch.train import executor as exmod
    from reverb_tpu_torch.train import trainer
    tag = '_device_feats' if device_feats else ''
    cfg_path = workdir / f'recipe{tag}.yaml'
    cfg_path.write_text(json.dumps(recipe_config(
        workdir, device_feats=device_feats)))
    model_dir = workdir / f'exp{tag}'
    rec = {'wait': [], 'step': [], 'audio': [], 'eval': 0, 'ln': [0]}

    def timed_train(orig):
        def train(self, model, optimizer, dataset, *a, **k):
            step_fn = self.train_step

            def timed_step(m, batch, g):
                t0 = time.perf_counter()
                out = step_fn(m, batch, g)       # ends in a host read
                rec['step'].append(time.perf_counter() - t0)
                rec['audio'].append(float(batch['feats_lengths'].sum())
                                    / 100.0)
                return out

            def timed_iter():
                it = iter(dataset)
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    rec['wait'].append(time.perf_counter() - t0)
                    yield batch
            self.train_step = timed_step
            try:
                return orig(self, model, optimizer, timed_iter(), *a, **k)
            finally:
                self.train_step = step_fn
        return train

    def counted_eval(orig):
        def make(cfg, **kw):
            fn = orig(cfg, **kw)

            def eval_step(m, batch, generator=None):
                rec['eval'] += 1
                return fn(m, batch, generator)
            return eval_step
        return make

    def counted_build(orig):
        def build(*a, **k):
            model = orig(*a, **k)
            calls, _ = ln_call_counter(model)
            rec['ln'] = calls
            return model
        return build
    zero_launch_counts()
    fa.BWD_LAUNCHES = ln.BWD_LAUNCHES = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with swapped({(exmod.Executor, 'train'):
                  timed_train(exmod.Executor.train),
                  (trainer, 'make_eval_step'):
                  counted_eval(trainer.make_eval_step),
                  (asr_model, 'build_model'):
                  counted_build(asr_model.build_model)}):
        ex = train_bin.main([
            '--config', str(cfg_path), '--data_type', 'raw',
            '--train_data', str(workdir / 'train.list'),
            '--cv_data', str(workdir / 'cv.list'),
            '--model_dir', str(model_dir), '--max_epoch', '1',
            '--steps_per_epoch', str(RECIPE_STEPS), '--log_interval', '1',
            '--seed', str(seed), '--device', 'cuda'])
    wall = time.perf_counter() - t0
    launches = {'K1': fa.LAUNCHES, 'K4': fa.BWD_LAUNCHES, 'K5': ln.LAUNCHES,
                'K6': ln.BWD_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    steps, n_eval = ex.step, rec['eval']
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    per = LN_ENC + LN_DEC
    want = {'K1': LAYERS_ENC * (steps + n_eval), 'K4': LAYERS_ENC * steps,
            'K5': per * (steps + n_eval), 'K6': per * steps}
    log(f'recipe train{tag}: {steps} steps, {n_eval} CV batches (a CV with '
        f'each snapshot, every {RECIPE_SAVE} steps, and at the epoch end); '
        f'launches {launches}, expected {want} (LayerNorm calls seen '
        f'{rec["ln"][0]})')
    if steps != RECIPE_STEPS or n_eval != RECIPE_STEPS // RECIPE_SAVE + 1 \
            or launches != want or \
            rec['ln'][0] != want['K5']:
        raise AssertionError('recipe train: the path did not run every '
                             'kernel the expected number of times')
    with np.load(model_dir / 'epoch_0.npz') as z:
        cmvn = (z['encoder.global_cmvn.mean'], z['encoder.global_cmvn.istd'])
        finite = all(np.isfinite(z[k]).all() for k in z.files)
    info = json.loads((model_dir / 'epoch_0.yaml').read_text())
    want_cmvn = load_cmvn(str(workdir / 'global_cmvn'))
    if not (finite and math.isfinite(info['cv_loss'])
            and info['step'] == RECIPE_STEPS
            and all(np.array_equal(a, b) for a, b in zip(cmvn, want_cmvn))
            and (model_dir / f'step_{RECIPE_SAVE}.npz').exists()):
        raise AssertionError(f'recipe train: epoch_0 {info}, finite '
                             f'{finite}')
    metrics = [json.loads(x) for x in
               (model_dir / 'metrics.jsonl').read_text().splitlines()]
    if [m['step'] for m in metrics] != list(range(1, RECIPE_STEPS + 1)) or \
            not all(math.isfinite(m['train/loss']) for m in metrics):
        raise AssertionError(f'recipe train: metrics {metrics}')
    n = len(rec['step'])
    step_ms = sum(rec['step'][1:]) / (n - 1) * 1e3
    wait_ms = sum(rec['wait'][1:n]) / (n - 1) * 1e3
    audio = sum(rec['audio'][1:]) / (n - 1)
    res = {'steps': steps, 'cv_batches': n_eval, 'launches': launches,
           'step_ms': step_ms, 'wait_ms': wait_ms,
           'first_step_ms': rec['step'][0] * 1e3,
           'first_wait_ms': rec['wait'][0] * 1e3,
           'audio_s_per_step': audio,
           'audio_s_per_s': audio / (step_ms + wait_ms) * 1e3,
           'peak_gib': peak / 2 ** 30, 'wall_s': wall,
           'cv_loss': info['cv_loss'],
           'losses': [m['train/loss'] for m in metrics]}
    log(f'recipe train{tag}: bin.train.main {wall:.1f} s in all; steps 2-{n}: '
        f'{step_ms:.1f} ms a step, {wait_ms:.2f} ms a step waiting on the '
        f'dataset iterator ({audio:.2f} s of audio a step: '
        f'{res["audio_s_per_s"]:.1f} audio-s/s); first step '
        f'{res["first_step_ms"]:.1f} ms after a {res["first_wait_ms"]:.1f} '
        f'ms wait; peak memory {res["peak_gib"]:.2f} GiB; losses '
        f'{[round(x, 3) for x in res["losses"]]}, cv_loss '
        f'{info["cv_loss"]:.4f}')
    return res


def recipe_first_batch(workdir: Path, configs: dict, tok, seed: int):
    """The first batch the recipe's training Dataset gives: B = 8 of the
    shortest utterances (the sort buffer holds the list), the Dataset's
    padding, dither and spec_aug on."""
    from reverb_tpu_torch.data.dataset import Dataset
    return next(iter(Dataset('raw', str(workdir / 'train.list'), tok,
                             configs['dataset_conf'], seed=seed)))


def recipe_dynamic_chunk(dev, workdir: Path, seed: int) -> dict:
    """One make_train_step step of a use_dynamic_chunk copy of the config
    on the recipe's first batch: a finite loss, K1 = K4 = 0 (the chunk
    mask takes the masked route), K5 and K6 at every LayerNorm."""
    import torch
    from reverb_tpu_torch.models.asr_model import ModelConfig, build_model
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    from reverb_tpu_torch.text.tokenizer import init_tokenizer
    from reverb_tpu_torch.train.executor import _device_batch
    from reverb_tpu_torch.train.trainer import (TrainConfig, build_optimizer,
                                                make_train_step)
    configs = recipe_config(workdir, dynamic_chunk=True)
    tok = init_tokenizer(configs)
    configs['output_dim'] = len(tok.symbol_table)
    batch = recipe_first_batch(workdir, configs, tok, seed)
    cfg = ModelConfig.from_config(configs)
    model = build_model(cfg, dev, generator=torch.Generator(
        device=dev).manual_seed(seed), train=True)
    opt, _ = build_optimizer(TrainConfig.from_config(configs), model)
    step = make_train_step(cfg, opt, grad_clip=50.0)
    db = _device_batch(batch, dev)
    ln_calls, hooks = ln_call_counter(model)
    zero_launch_counts()
    fa.BWD_LAUNCHES = ln.BWD_LAUNCHES = 0
    try:
        t0 = time.perf_counter()
        m = step(model, db, torch.Generator(device=dev).manual_seed(seed))
        wall = time.perf_counter() - t0
    finally:
        for h in hooks:
            h.remove()
    launches = {'K1': fa.LAUNCHES, 'K4': fa.BWD_LAUNCHES, 'K5': ln.LAUNCHES,
                'K6': ln.BWD_LAUNCHES}
    want = {'K1': 0, 'K4': 0, 'K5': LN_ENC + LN_DEC, 'K6': LN_ENC + LN_DEC}
    log(f'recipe dynamic chunk: one step at B={len(batch["keys"])} (T '
        f'{batch["feats"].shape[1]}): {m}; {wall * 1e3:.1f} ms; launches '
        f'{launches}, expected {want} (LayerNorm calls seen {ln_calls[0]})')
    if launches != want or ln_calls[0] != want['K5'] or \
            not math.isfinite(m['loss']) or m['skipped'] != 0.0:
        raise AssertionError('recipe dynamic chunk step')
    del model, opt, step, db
    torch.cuda.empty_cache()
    return {'launches': launches, 'loss': m['loss'], 'ms': wall * 1e3}


def recipe_scripts(dev, workdir: Path) -> dict:
    """average_model over the step-RECIPE_SAVE snapshot and epoch_0;
    get_loss on the CV list (8 finite lines); recognize with the serving
    mode pair on the CV list in bf16 (per batch K1 = 18, K2 = K3 = 1, plus
    one of each per batch whose hypotheses outgrow max_hyp_len; K5 at every
    LayerNorm call)."""
    import gc
    import torch
    from reverb_tpu_torch.bin import average_model, get_loss, recognize
    from reverb_tpu_torch.decode import api
    from reverb_tpu_torch.ops import beam_scan as bs
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    exp = workdir / 'exp'
    res = {}
    t0 = time.perf_counter()
    average_model.main(['--dst_model', str(workdir / 'avg.npz'), '--models',
                        str(exp / f'step_{RECIPE_SAVE}.npz'),
                        str(exp / 'epoch_0.npz')])
    res['average_model_s'] = time.perf_counter() - t0
    with np.load(workdir / 'avg.npz') as a, \
            np.load(exp / 'epoch_0.npz') as b:
        if sorted(a.files) != sorted(b.files) or not all(
                np.isfinite(a[k]).all() and a[k].dtype == np.float32
                for k in a.files):
            raise AssertionError('recipe average_model')
    log(f'recipe average_model: step_{RECIPE_SAVE} + epoch_0 → avg.npz in '
        f'{res["average_model_s"]:.1f} s')

    seen = {'ln': [0]}

    def hooked(orig):
        def load(*a, **k):
            model = orig(*a, **k)
            seen['ln'] = ln_call_counter(model)[0]
            return model
        return load
    zero_launch_counts()
    t0 = time.perf_counter()
    with swapped({(recognize, 'load_model_for_eval'):
                  hooked(recognize.load_model_for_eval)}):
        get_loss.main(['--config', str(exp / 'train.yaml'), '--checkpoint',
                       str(exp / 'epoch_0.npz'), '--test_data',
                       str(workdir / 'cv.list'), '--output',
                       str(workdir / 'loss.txt'), '--device', 'cuda'])
    res['get_loss_s'] = time.perf_counter() - t0
    rows = [r.split() for r in
            (workdir / 'loss.txt').read_text().splitlines()]
    launches = launch_counts()
    want = {'K1': LAYERS_ENC * RECIPE_CV, 'K2': 0, 'K3': 0,
            'K5': (LN_ENC + LN_DEC) * RECIPE_CV}
    log(f'recipe get_loss: {len(rows)} lines in {res["get_loss_s"]:.1f} s, '
        f'first {rows[0] if rows else None}; launches {launches}, expected '
        f'{want}')
    if len(rows) != RECIPE_CV or not all(
            len(r) == 4 and all(math.isfinite(float(x)) for x in r[1:])
            for r in rows) or launches != want or seen['ln'][0] != want['K5']:
        raise AssertionError('recipe get_loss')
    res['get_loss_launches'] = launches
    gc.collect()
    torch.cuda.empty_cache()

    calls = {'decode': 0, 'uncapped': 0}

    def counted(name):
        def wrap(orig):
            def fn(*a, **k):
                calls[name] += 1
                return orig(*a, **k)
            return fn
        return wrap
    zero_launch_counts()
    t0 = time.perf_counter()
    with swapped({(recognize, 'load_model_for_eval'):
                  hooked(recognize.load_model_for_eval),
                  (api, 'decode'): counted('decode')(api.decode),
                  (api, '_decode_uncapped'):
                  counted('uncapped')(api._decode_uncapped)}):
        recognize.main(['--config', str(exp / 'train.yaml'), '--checkpoint',
                        str(exp / 'epoch_0.npz'), '--test_data',
                        str(workdir / 'cv.list'), '--result_dir',
                        str(workdir / 'rec'), '--modes', *RECIPE_MODES,
                        '--device', 'cuda'])
    res['recognize_s'] = time.perf_counter() - t0
    launches = launch_counts()
    nb, nu = calls['decode'], calls['uncapped']
    want = {'K1': LAYERS_ENC * nb, 'K2': nb + nu, 'K3': nb + nu,
            'K5': seen['ln'][0]}
    texts = {m: (workdir / 'rec' / m / 'text').read_text(
        encoding='utf8').splitlines() for m in RECIPE_MODES}
    log(f'recipe recognize: {nb} batches ({nu} through the uncapped tail) '
        f'in {res["recognize_s"]:.1f} s; launches {launches}, expected '
        f'{want}; rows {[len(t) for t in texts.values()]}; first '
        f'{texts[RECIPE_MODES[-1]][0][:80]!r}')
    if nb != 1 or launches != want or seen['ln'][0] < LN_ENC * nb or \
            any(len(t) != RECIPE_CV for t in texts.values()):
        raise AssertionError('recipe recognize')
    res.update(recognize_launches=launches, recognize_batches=nb,
               recognize_uncapped=nu)
    gc.collect()
    torch.cuda.empty_cache()
    return res


# each kernel's outputs at every call of the recipe's f32 check, within
# this share of the output's largest value of its plain version on the
# call's own inputs: the f32 tolerances of check_k1_mask_k4 and check_ln
RECIPE_CALL_TOL = {'K1': 1e-3, 'K4': 1e-3, 'K5': 1e-4, 'K6': 1e-4}


def checked_kernels(errs):
    """K1, K4, K5 and K6 as module attributes to swap in: each call runs
    the kernel, then its plain version on the call's own inputs (K4 and K6
    with the call's own upstream gradient), and keeps each output's worst
    error relative to the output's largest value in errs.  K1's output is
    compared on valid query rows only (a padded row is read by no one)."""
    import torch
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    k1, k4, k5, k6 = fa._k1, fa._k4, ln.layer_norm_fwd, ln.layer_norm_bwd

    def keep(name, got, want):
        errs[name] = max(errs.get(name, 0.0), rel_err(got, want.reshape(
            got.shape)))

    def plain_attn(q, k, v, p, u, vb, lens, mask, rate):
        return fa.rel_pos_attention_plain(q, k, v, p[None], u, vb, lens,
                                          mask, rate)

    def fwd(q, k, v, p, u, vb, lens, mask, rate, want_lse):
        out, lse = k1(q, k, v, p, u, vb, lens, mask, rate, want_lse)
        with torch.no_grad():
            want = plain_attn(q, k, v, p, u, vb, lens, mask, rate)
        ok = (torch.arange(q.shape[2], device=q.device)[None, :]
              < lens[:, None])[:, None, :, None]
        keep('K1 out', out * ok, want * ok)
        return out, lse

    def bwd(q, k, v, p, u, vb, lens, mask, rate, out, lse, g):
        got = k4(q, k, v, p, u, vb, lens, mask, rate, out, lse, g)
        with torch.enable_grad():
            ins = [t.detach().clone().requires_grad_(True)
                   for t in (q, k, v, p, u, vb)]
            want = torch.autograd.grad(
                plain_attn(*ins, lens, mask, rate), ins, g)
        for n, a, b in zip(('dq', 'dk', 'dv', 'dp', 'du', 'dvb'), got, want):
            keep(f'K4 {n}', a, b)
        return got

    def ln_fwd(x, weight, bias, eps):
        y = k5(x, weight, bias, eps)
        keep('K5 y', y, ln.layer_norm_plain(x, weight, bias, eps))
        return y

    def ln_bwd(x, weight, g, eps):
        got = k6(x, weight, g, eps)
        for n, a, b in zip(('dx', 'dw', 'db'), got,
                           ln.layer_norm_bwd_plain(x, weight, g, eps)):
            keep(f'K6 {n}', a, b)
        return got
    return {(fa, '_k1'): fwd, (fa, '_k4'): bwd, (ln, 'layer_norm_fwd'): ln_fwd,
            (ln, 'layer_norm_bwd'): ln_bwd}


def check_call_errs(errs, what: str):
    """Raise unless every kernel output in errs is within RECIPE_CALL_TOL
    and each of K1, K4, K5 and K6 was seen."""
    bad = {n: e for n, e in errs.items()
           if not e <= RECIPE_CALL_TOL[n.split()[0]]}
    seen = {n.split()[0] for n in errs}
    if bad or seen != set(RECIPE_CALL_TOL):
        raise AssertionError(f'{what}: kernel calls against their plain '
                             f'versions {errs} (tolerances '
                             f'{RECIPE_CALL_TOL}; kernels seen {seen})')


def recipe_reference_check(dev, workdir: Path, seed: int) -> dict:
    """The recipe's own inputs in f32 (TF32 off) on the epoch_0 weights,
    the kernels against their plain versions.

    Training, on the recipe's first training batch (`recipe_first_batch`):
    compute_loss + backward through the kernels, every K1/K4/K5/K6 call
    held to its plain version on that call's inputs (`checked_kernels`,
    RECIPE_CALL_TOL); again through the plain versions, and in f64
    (`f64_versions`).  The loss within 1e-5 relative of the plain one; the kernels'
    gradient no further from the f64 gradient than twice the plain f32
    gradient is (on this batch the plain f32 gradient itself is ~1e-4 from
    the f64 one: a difference of rounding alone moves the small gradients
    of the decoders' ReLU layers by ~1e-3, so the per-tensor bound of
    `train_reference_check` holds no version here).

    Decoding, on recognize's CV batch (its test pipeline: B = 8, the
    Dataset's padding): the encoder through the kernels (each K1/K5 call
    held as above) and through the plain versions, valid frames within
    1e-3; then recognize's decode (RECIPE_MODES at its defaults) twice on
    the SAME encoder output (K2, K3, K5 in the decoder): tokens, times and
    nbest identical, scores within 1e-4 or one f32 step, as `modes` holds
    its decodes."""
    import gc
    import torch
    from reverb_tpu_torch.bin.recognize import (eval_dataset,
                                                load_model_for_eval)
    from reverb_tpu_torch.cli.reverb import get_blank_id
    from reverb_tpu_torch.decode import api
    from reverb_tpu_torch.models.asr_model import build_model
    from reverb_tpu_torch.ops import beam_scan as bs
    from reverb_tpu_torch.text.tokenizer import init_tokenizer
    from reverb_tpu_torch.train.executor import _device_batch
    from reverb_tpu_torch.utils.config import load_config
    exp = workdir / 'exp'
    configs = load_config(exp / 'train.yaml')
    tok = init_tokenizer(configs)
    configs, _ = get_blank_id(configs, tok.symbol_table)
    configs['output_dim'] = len(tok.symbol_table)
    served = load_model_for_eval(configs, exp / 'epoch_0.npz', dev, True)
    cfg = served.cfg.with_compute_dtype(torch.float32)
    model = build_model(cfg, dev, state_dict=served.state_dict(), train=True)
    del served
    batch = recipe_first_batch(workdir, configs, tok, seed)
    db = _device_batch(batch, dev)
    errs = {}
    loss_k, g_k = loss_and_grads(model, db, dev, checked_kernels(errs))
    check_call_errs(errs, 'recipe reference, training batch')
    loss_p, g_p = loss_and_grads(model, db, dev, plain_versions())
    m64 = build_model(cfg.with_compute_dtype(torch.float64), dev,
                      state_dict=model.state_dict(), train=True).double()
    d64 = {k: v.double() if v.is_floating_point() else v
           for k, v in db.items()}
    loss_d, g_d = loss_and_grads(m64, d64, dev, f64_versions())
    del m64, d64
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    dist = {'kernels vs plain': grad_dist(g_k, g_p),
            'kernels vs f64': grad_dist(g_k, g_d),
            'plain vs f64': grad_dist(g_p, g_d)}
    log(f'recipe reference: epoch_0 in f32 on the first training batch '
        f'(B={len(batch["keys"])}, T {batch["feats"].shape[1]}, lengths '
        f'{batch["feats_lengths"].tolist()}), dropout 0.1: every kernel call '
        f'against its plain version, worst share of scale '
        + ', '.join(f'{n} {e:.2e}' for n, e in sorted(errs.items()))
        + f'; loss {loss_k:.6f} vs plain {loss_p:.6f} (rel {loss_rel:.2e}), '
        f'f64 {loss_d:.6f}; gradient distances '
        + ', '.join(f'{n} {d:.2e}' for n, d in dist.items()))
    if not (loss_rel <= 1e-5 and
            dist['kernels vs f64'] <= 2 * dist['plain vs f64']):
        raise AssertionError('recipe reference: the training batch\'s loss '
                             'or gradient through the kernels differs from '
                             'the plain versions')
    res = {'call_errs': dict(errs), 'loss_rel': loss_rel, **dist}
    del g_k, g_p, g_d
    model.eval().requires_grad_(False)

    cv = next(iter(eval_dataset(configs, tok, 'raw',
                                str(workdir / 'cv.list'), 16)))
    feats, lens = cv['feats'], cv['feats_lengths']
    cat = np.asarray([1.0, 0.0], np.float32)       # verbatimicity 1
    plain = {(bs, 'beam_scan_forward'): bs.beam_scan_forward_plain,
             (bs, 'beam_backtrace'): bs.beam_backtrace_plain,
             **plain_versions()}
    x = torch.from_numpy(feats).to(dev)
    x_lens = torch.from_numpy(lens).to(dev)
    enc_errs, encoded = {}, []
    for table in (checked_kernels(enc_errs), plain):
        with swapped(table), torch.inference_mode():
            encoded.append(model.forward_encoder(
                x, x_lens, torch.from_numpy(cat).to(dev)))
    (enc_k, mask), (enc_p, _) = encoded
    enc_err = float(((enc_k - enc_p).abs() * mask[:, 0, :, None]).max())
    bad = {n: e for n, e in enc_errs.items()
           if not e <= RECIPE_CALL_TOL[n.split()[0]]}
    if bad or {n.split()[0] for n in enc_errs} != {'K1', 'K5'} or \
            not enc_err <= 1e-3:
        raise AssertionError(f'recipe reference: f32 encoder on the CV '
                             f'batch, kernel vs plain err {enc_err}, kernel '
                             f'calls {enc_errs}')

    def run(kernels: bool):
        table = {(model, 'forward_encoder'): lambda *a, **k: (enc_k, mask),
                 **({} if kernels else plain)}
        with swapped(table):
            return api.decode(model, RECIPE_MODES, feats, lens,
                              beam_size=10, ctc_weight=0.1, cat_embs=cat)
    got, want = run(True), run(False)
    n_tok = {m: [len(r.tokens) for r in want[m]] for m in want}
    compare_results(got, want, 1e-4, ulps=1)
    if not all(sum(n_tok[m]) for m in RECIPE_MODES):
        raise AssertionError(f'recipe reference: the decode emitted no '
                             f'tokens ({n_tok})')
    log(f'recipe reference: the CV batch (B={len(cv["keys"])}, T '
        f'{feats.shape[1]}, lengths {lens.tolist()}) in f32: every encoder '
        f'kernel call against its plain version, worst share of scale '
        + ', '.join(f'{n} {e:.2e}' for n, e in sorted(enc_errs.items()))
        + f'; encoder max abs err on valid frames {enc_err:.2e}; '
        f'recognize\'s decode {RECIPE_MODES} on one encoder output, kernels '
        f'vs plain: tokens, times and nbest identical, scores within 1e-4 or '
        f'one f32 step (tokens of each best hyp {n_tok})')
    res.update(encoder_err=enc_err, encoder_call_errs=enc_errs)
    del model, encoded, enc_k, enc_p, mask
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_recipe(dev, seed=SEED):
    """The dataset path at reverb_large width: a synthetic corpus, then
    `bin.train` (6 steps at B = 8 with a mid-epoch snapshot and CV), one
    dynamic-chunk step, then `bin.average_model`, `bin.get_loss` and
    `bin.recognize`, then the kernels against their plain versions on the
    recipe's own batches (`recipe_reference_check`)."""
    import shutil
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='reverb_recipe_') as tmp:
        workdir = Path(tmp)
        t0 = time.perf_counter()
        audio_s = recipe_corpus(workdir, seed + 70)
        free = shutil.disk_usage(tmp).free / 2 ** 30
        log(f'recipe corpus: {RECIPE_TRAIN} + {RECIPE_CV} WAVs '
            f'({audio_s["train"]:.1f} + {audio_s["cv"]:.1f} s of audio) and '
            f'the CMVN stats in {time.perf_counter() - t0:.1f} s; {free:.0f} '
            f'GiB free in {tmp}')
        res = {'corpus_audio_s': audio_s,
               'train': recipe_train(dev, workdir, seed),
               'dynamic_chunk': recipe_dynamic_chunk(dev, workdir, seed)}
        res.update(recipe_scripts(dev, workdir))
        res['reference'] = recipe_reference_check(dev, workdir, seed)
    log(f'recipe: the phase took {time.perf_counter() - t_phase:.1f} s; on '
        f'{smi_line()}')
    return res


# ------------------------------ phase 13: context biasing ------------------------------

CTX_PHRASES = 120            # distinct phrases of each context graph here
CTX_SCORE = 3.0              # their context_score in the kernel check
# the context_scores the serving and tools graphs try, highest first: the
# first one that changes the output (serving: without overflowing
# max_hyp_len) is kept.  The random model's blank and its commonest token
# lie within a few tenths of a nat on most frames, so a small bonus
# already lengthens its hypotheses.
CTX_SCORES = (3.0, 1.0, 0.3, 0.1, 0.03)
ADAPTOR_STEPS = 3            # bf16 steps of the deep-biasing model


def k2b_launches() -> int:
    from reverb_tpu_torch.ops import beam_scan as bs
    return bs.BIASED_LAUNCHES


def token_graph(phrases, score=CTX_SCORE):
    """A ContextGraph (context_score `score`) of token-id phrases."""
    from reverb_tpu_torch.decode.context_graph import ContextGraph
    g = ContextGraph(context_list=[], symbol_table={}, context_score=score)
    g.build([[int(t) for t in p] for p in phrases])
    return g


def topk_phrases(ix, seed, n=CTX_PHRASES):
    """n distinct phrases of 2-4 tokens that occur in the top-k ix (B, T,
    K), sorted: half follow a row's top-1 path (a run of the tokens it
    emits, one of them replaced by the second or third choice at its frame
    where that is not blank), half are drawn from every non-blank token of
    the top-k."""
    rng = np.random.RandomState(seed)
    top = ix.cpu().numpy()
    paths = []
    for row in top:
        t1 = row[:, 0]
        emit = np.flatnonzero((t1 != 0) & (t1 != np.r_[-1, t1[:-1]]))
        if len(emit) > 4:
            paths.append((row, emit))
    pool = sorted(set(top.flatten().tolist()) - {0})
    if len(pool) < 3:
        raise AssertionError(f'the top-k holds {len(pool)} non-blank tokens')
    out = set()
    for _ in range(20 * n if paths else 0):
        if len(out) >= n // 2:
            break
        row, emit = paths[rng.randint(len(paths))]
        k = rng.randint(2, 5)
        frames = emit[rng.randint(len(emit) - k + 1):][:k]
        p = row[frames, 0].copy()
        j = rng.randint(k)
        alt = row[frames[j], 1 + rng.randint(2)]
        if alt != 0:
            p[j] = alt
        out.add(tuple(int(t) for t in p))
    while len(out) < n:
        out.add(tuple(int(t) for t in rng.choice(pool, rng.randint(2, 5))))
    return sorted(out)


def check_beam_biased(dev, seed):
    """K2b against the plain biased scan at B = 8, T = 512, K = K2 = 10 on
    peaky top-k with a graph of CTX_PHRASES phrases of tokens from that
    top-k: every record, plen, last, hash and trie state exactly, the
    scores and bonuses within 1e-4; then the whole biased search (K2b, K3)
    against the plain one, full length and ragged (a row of 0 and of 1
    frame): prefixes, plens and times exactly, scores within 1e-4, and the
    graph changing the best hypothesis of some row against the unbiased
    search.  Times K2b per call and on the device alone beside the
    unbiased K2 and the plain biased scan."""
    import torch
    from reverb_tpu_torch.decode import prefix_beam as pb
    from reverb_tpu_torch.ops import beam_scan as bs
    B, T, K = 8, 512, 10
    lp, ix, blank = peaky_topk(dev, seed + 200)
    g = token_graph(topk_phrases(ix, seed + 201))
    tables = pb._graph_tables(g, VOCAB, dev)
    nt_st = tables[:2]
    errs, changed = [], 0
    plain = {(bs, 'beam_scan_forward'): bs.beam_scan_forward_plain,
             (bs, 'beam_backtrace'): bs.beam_backtrace_plain}
    for what, lens in (('full length', [T] * B),
                       ('ragged', [512, 480, 400, 512, 1, 256, 100, 0])):
        lens = torch.tensor(lens, device=dev)
        ts = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(
            B, T).contiguous()
        valid = torch.arange(T, device=dev)[None] < lens[:, None]
        acc = torch.zeros((B, T), dtype=torch.float32, device=dev)
        hs = torch.zeros((B, T), dtype=torch.bool, device=dev)
        args = (lp, ix, ts, valid, acc, hs, K, 0)
        got = bs.beam_scan_forward(*args, ctx_tables=nt_st)
        want = bs.beam_scan_forward_plain(*args, ctx_tables=nt_st)
        errs.append(assert_beam_records(got, want, f'K2b {what}'))
        if not torch.equal(got[0]['ctx'], want[0]['ctx']):
            raise AssertionError(f'K2b {what}: final trie states differ')
        errs.append(float((got[0]['cum'] - want[0]['cum']).abs().max()))
        if not errs[-1] <= 1e-4:
            raise AssertionError(f'K2b {what}: bonuses differ by {errs[-1]}')
        out_k = pb.ctc_prefix_beam_search_device_topk(
            lp, ix, blank, lens, K, 0, 256, 0.0, 0, tables)
        with swapped(plain):
            out_p = pb.ctc_prefix_beam_search_device_topk(
                lp, ix, blank, lens, K, 0, 256, 0.0, 0, tables)
        unbiased = pb.ctc_prefix_beam_search_device_topk(
            lp, ix, blank, lens, K, 0, 256)
        torch.cuda.synchronize()
        for a, b, name in zip(out_k, out_p, ('prefixes', 'plens', 'scores',
                                            'times')):
            if b.dtype.is_floating_point:
                errs.append(float((a - b).abs().max()))
                if not errs[-1] <= 1e-4:
                    raise AssertionError(f'biased beam {what}: {name} differ '
                                         f'by {errs[-1]}')
            elif not torch.equal(a, b):
                raise AssertionError(f'biased beam {what}: {name} differ')
        n_changed = int(((out_k[0][:, 0] != unbiased[0][:, 0]).any(-1)
                         | (out_k[1][:, 0] != unbiased[1][:, 0])).sum())
        changed += n_changed
        log(f'K2b+K3 biased beam ({what}, {g.num_nodes + 1} trie states, '
            f'{CTX_PHRASES} phrases): records, trie states, prefixes, plens '
            f'and times equal to the plain scan, score err {max(errs):.2e}; '
            f'the graph changed the best hypothesis of {n_changed} of {B} '
            f'rows')
    if not changed:
        raise AssertionError('the context graph changed no hypothesis')
    ts = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(
        B, T).contiguous()
    valid = torch.ones((B, T), dtype=torch.bool, device=dev)
    acc = torch.zeros((B, T), dtype=torch.float32, device=dev)
    hs = torch.zeros((B, T), dtype=torch.bool, device=dev)
    args = (lp, ix, ts, valid, acc, hs, K, 0)
    final, em = bs.beam_scan_forward(*args, ctx_tables=nt_st)
    t = {'plain': cuda_time_ms(
        lambda: bs.beam_scan_forward_plain(*args, ctx_tables=nt_st), 1)}
    t['ms'], t['device_ms'] = both_times(
        lambda: bs.beam_scan_forward(*args, ctx_tables=nt_st), 5,
        KERNEL_PATTERNS['K2b'])
    t['k2_ms'], t['k2_device_ms'] = both_times(
        lambda: bs.beam_scan_forward(*args), 5, KERNEL_PATTERNS['K2'])
    t['us_frame'] = t['device_ms'] * 1e3 / T
    # each input read once, each output written once, and the table
    # entries this run gathers: 4 + 4 bytes for each cell of a valid frame
    t['nbytes'] = (nbytes(args[:6], final, em)
                   + int(valid.sum()) * K * ix.shape[2] * 8)
    log(f'K2b biased beam_scan_forward: kernel {t["ms"]:.4f} ms per call '
        f'({t["device_ms"]:.4f} on the device, {t["us_frame"]:.3f} us a '
        f'frame), unbiased K2 in the same process {t["k2_ms"]:.4f} ms '
        f'({t["k2_device_ms"]:.4f} on the device), plain biased '
        f'{t["plain"]:.1f} ms (B=8, T=512, K=10); on {smi_line()}')
    return max(errs), t


def file_topk(asr, feats):
    """The CTC top-10 token ids (B, T, 10) of the file's chunks: the
    tokens a context graph can promote."""
    import torch
    from reverb_tpu_torch.decode import api
    dev = feats.device
    batch, lens = next(asr.feats_batcher(feats, CHUNK, N_CHUNKS))
    with torch.inference_mode():
        return api.encode_and_ctc_topk(
            asr.model, batch, torch.from_numpy(lens).to(dev),
            torch.tensor([1.0, 0.0], device=dev), 10)[3]


def matched_rows(a: str, b: str) -> int:
    """The rows two CTMs share in order (difflib's matching blocks): a
    word that one of them adds or drops costs its own row only."""
    import difflib
    ra, rb = a.splitlines(), b.splitlines()
    return sum(m.size for m in difflib.SequenceMatcher(
        None, ra, rb, autojunk=False).get_matching_blocks())


def matched_tokens(got, want) -> tuple:
    """(tokens of the hypotheses `want` that `got`'s share in order,
    tokens of `want`), over two lists of token lists."""
    import difflib
    return (sum(m.size for a, b in zip(got, want)
                for m in difflib.SequenceMatcher(
                    None, a, b, autojunk=False).get_matching_blocks()),
            sum(len(b) for b in want))


def run_context_serving(dev, asr, wav, feats, audio_s):
    """Biased serving at reverb_large width in bf16.  One unbiased
    `transcribe_modes(MODES, format='ctm')` call; a graph of CTX_PHRASES
    distinct phrases of the tokens in the file's CTC top-k (`topk_phrases`)
    at the first context_score of CTX_SCORES whose biased call changes some
    CTM row and runs no uncapped tail (no hypothesis past max_hyp_len);
    then, counted: two biased calls (a warm-up and a timed one) with
    launches K1 = 18 and K2b = K3 = 1 per encoder call, K2 never, and one
    with max_hyp_len FALLBACK_MAX_HYP_LEN, where the uncapped tail runs K2b
    and K3 again.  The same biased call with K2b and K3 swapped for their
    plain versions gives the same CTM bytes; with every kernel swapped (K1
    and K5 too: the bf16 encoder output moves) the best hypotheses' tokens
    that still match are counted, biased and unbiased."""
    import functools
    import torch
    from reverb_tpu_torch.cli import reverb as rv
    from reverb_tpu_torch.decode import api
    from reverb_tpu_torch.ops import beam_scan as bs
    captured, tails = [], []
    decode_fn, tail_fn = rv.decode_modes_fn, api._decode_uncapped
    cap = [None]

    def recording(*args, **kwargs):
        if cap[0] is not None:
            kwargs['max_hyp_len'] = cap[0]
        out = decode_fn(*args, **kwargs)
        captured.append(out)
        return out

    @functools.wraps(tail_fn)
    def tail(*args, **kwargs):
        tails.append(1)
        return tail_fn(*args, **kwargs)

    def changed_rows(out, ref):
        return {m: len(c.splitlines()) - matched_rows(c, c0)
                for m, c, c0 in zip(MODES, out, ref)}

    def run(g=None):
        """One call: (CTM strings, uncapped tails, the longest best
        hypothesis of the prefix beam, each chunk's best hypothesis of
        each mode)."""
        del captured[:], tails[:]
        out = asr.transcribe_modes(str(wav), MODES, format='ctm',
                                   context_graph=g)
        best = {m: [r.tokens for res in captured for r in res[m]]
                for m in MODES}
        return out, len(tails), max(
            len(t) for t in best['ctc_prefix_beam_search']), best
    phrases = topk_phrases(file_topk(asr, feats), SEED + 210)
    tried = {}
    with swapped({(rv, 'decode_modes_fn'): recording,
                  (api, '_decode_uncapped'): tail}):
        base, _, base_len, base_tok = run()
        for score in CTX_SCORES:
            g = token_graph(phrases, score)
            out, n_tails, longest, out_tok = run(g)
            tried[score] = (n_tails, longest, changed_rows(out, base))
            if not n_tails and any(tried[score][2].values()):
                break
        else:
            raise AssertionError(f'no context_score of {CTX_SCORES} changes '
                                 f'a CTM row without an uncapped tail: '
                                 f'(tails, longest hypothesis, changed rows) '
                                 f'{tried}')
        log(f'biased serving: longest best hypothesis {base_len} tokens '
            f'unbiased; context_score tried (uncapped tails, longest best '
            f'hypothesis, CTM rows changed) {tried}; kept {score}')

        def counted(n_calls, max_hyp_len=None):
            cap[0] = max_hyp_len
            del captured[:], tails[:]
            ln_calls, hooks = ln_call_counter(asr.model)
            zero_launch_counts()
            walls = []
            try:
                for _ in range(n_calls):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = asr.transcribe_modes(str(wav), MODES, format='ctm',
                                               context_graph=g)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
            finally:
                for h in hooks:
                    h.remove()
                cap[0] = None
            launches = dict(launch_counts(), K2b=k2b_launches())
            n_enc, n_beam = len(captured), len(captured) + len(tails)
            want = {'K1': LAYERS_ENC * n_enc, 'K2': 0, 'K3': n_beam,
                    'K5': ln_calls[0], 'K2b': n_beam}
            what = ('no cap' if max_hyp_len is None
                    else f'max_hyp_len={max_hyp_len}')
            log(f'biased serving ({what}) launches {launches}, expected '
                f'{want} ({n_enc} encoder calls in {n_calls} '
                f'transcribe_modes calls, {len(tails)} uncapped tails)')
            if launches != want or ln_calls[0] < LN_ENC * n_enc or \
                    len(tails) != (0 if max_hyp_len is None else n_enc):
                raise AssertionError(f'biased serving ({what}) did not run '
                                     f'every kernel the expected number of '
                                     f'times')
            return out, launches, walls, n_enc
        out, launches, walls, n_enc = counted(2)
        out_tail, launches_tail, walls_tail, _ = counted(
            1, FALLBACK_MAX_HYP_LEN)
    rows = {m: check_ctm_rows(c, wav.name, m) for m, c in zip(MODES, out)}
    for m, c in zip(MODES, out_tail):
        check_ctm_rows(c, wav.name, m)
    changed = changed_rows(out, base)
    plain_beam = {(bs, 'beam_scan_forward'): bs.beam_scan_forward_plain,
                  (bs, 'beam_backtrace'): bs.beam_backtrace_plain}
    with swapped(plain_beam):
        out_pb = asr.transcribe_modes(str(wav), MODES, format='ctm',
                                      context_graph=g)
    if out_pb != out:
        raise AssertionError('biased serving: the CTM with K2b and K3 differs '
                             'from the CTM with their plain versions')
    # every kernel plain: the bf16 encoder output moves, and tokens whose
    # log-probs lie within that rounding of blank's may flip
    with swapped({**plain_beam, **plain_versions(),
                  (rv, 'decode_modes_fn'): recording,
                  (api, '_decode_uncapped'): tail}):
        out_p, _, _, out_tok_p = run(g)
        base_p, _, _, base_tok_p = run()
    if out_p == base_p:
        raise AssertionError('the context graph changed no CTM row with the '
                             'plain versions')
    agree = {m: matched_tokens(out_tok[m], out_tok_p[m]) for m in MODES}
    agree_base = {m: matched_tokens(base_tok[m], base_tok_p[m])
                  for m in MODES}
    log(f'biased serving: {audio_s:.2f} s of audio, {len(phrases)} distinct '
        f'phrases ({g.num_nodes + 1} trie states), context_score {score}; '
        f'transcribe_modes wall {walls[0]:.4f} s (first), {walls[1]:.4f} s '
        f'(second, xRT {audio_s / walls[1]:.1f}), {walls_tail[0]:.4f} s with '
        f'max_hyp_len={FALLBACK_MAX_HYP_LEN} (the uncapped tail on every '
        f'chunk); CTM rows {rows}, unbiased '
        f'{ {m: len(c.splitlines()) for m, c in zip(MODES, base)} }, rows '
        f'not matched in the unbiased CTM {changed}; CTM with K2b/K3 '
        f'swapped for their plain versions byte-equal; with every kernel '
        f'plain (the random model emits no word boundary: a CTM row is a '
        f'chunk), best-hypothesis tokens matched in order (of the plain '
        f'run\'s) biased {agree}, unbiased {agree_base}: the bf16 encoder '
        f'output moves, and tokens within its rounding of blank flip with '
        f'or without the graph')
    return {'launches': launches, 'calls': 2, 'n_enc': n_enc,
            'launches_tail': launches_tail, 'walls': walls,
            'wall_tail': walls_tail[0], 'changed': changed, 'score': score,
            'phrases': len(phrases), 'states': g.num_nodes + 1,
            'tried': tried}


def adaptor_model(dev, seed, dtype):
    """presets.reverb_large with deep_bias_conf.deep_biasing (a context
    adaptor beside the encoder), randomly initialized from `seed`; with
    its optimizer and train step."""
    import torch
    from reverb_tpu_torch.models import presets
    from reverb_tpu_torch.models.asr_model import ModelConfig, build_model
    from reverb_tpu_torch.train.trainer import (TrainConfig,
                                                build_optimizer,
                                                make_train_step)
    configs = presets.reverb_large()
    configs.setdefault('dataset_conf', {})['deep_bias_conf'] = {
        'deep_biasing': True}
    cfg = ModelConfig.from_config(configs).with_compute_dtype(dtype)
    if not cfg.context_adaptor:
        raise AssertionError('deep_biasing did not reach the model config')
    model = build_model(cfg, dev, generator=torch.Generator(
        device=dev).manual_seed(seed), train=True)
    tc = TrainConfig.from_config(configs)
    opt, _ = build_optimizer(tc, model)
    return model, opt, make_train_step(cfg, opt, tc.accum_grad, tc.grad_clip)


def with_cv_list(batch, seed):
    """`batch` with the context phrases of a deep-biasing batch: two spans
    of 2-4 tokens of each utterance's target, padded with 0."""
    import torch
    rng = np.random.RandomState(seed)
    target = batch['target'].cpu().numpy()
    tlens = batch['target_lengths'].cpu().numpy()
    terms = []
    for row, n in zip(target, tlens):
        for _ in range(2):
            k = rng.randint(2, 5)
            i = rng.randint(0, n - k)
            terms.append(row[i:i + k])
    cv = np.zeros((len(terms), 4), np.int64)
    for i, t in enumerate(terms):
        cv[i, :len(t)] = t
    dev = batch['feats'].device
    return dict(batch, cv_list=torch.from_numpy(cv).to(dev),
                cv_list_lengths=torch.tensor([len(t) for t in terms],
                                             device=dev))


def run_adaptor_training(dev, seed):
    """The deep-biasing model: f32 at B = 2 with dropout and a cv_list
    batch, one loss + backward through the kernels with every K1/K4/K5/K6
    call held to its plain version on its own inputs (`checked_kernels`),
    once through the plain versions and once in f64 (`f64_versions`), as
    `recipe_reference_check` holds a training batch: the loss within 1e-5
    relative of the plain one, the kernels' gradient no further from the
    f64 one than twice the plain f32 gradient is (the f32 noise floor of
    this model, 1e-4 globally, is what `train_reference_check`'s bound
    sits on), the adaptor's gradient non-zero; then ADAPTOR_STEPS bf16
    steps at B = 8 with a cv_list batch: launches K1 = K4 = 18 and K5 = K6
    = 120 a step, finite losses, the adaptor's parameters updated and its
    bias zero on the frames that pick the blank term only."""
    import torch
    from reverb_tpu_torch.models.asr_model import build_model
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    model, _, _ = adaptor_model(dev, seed, torch.float32)
    batch = with_cv_list(train_batch(dev, 2, seed + 1, model.cfg.vocab_size),
                         seed)
    errs = {}
    loss_k, g_k = loss_and_grads(model, batch, dev, checked_kernels(errs))
    check_call_errs(errs, 'adaptor reference')
    loss_p, g_p = loss_and_grads(model, batch, dev, plain_versions())
    m64 = build_model(model.cfg.with_compute_dtype(torch.float64), dev,
                      state_dict=model.state_dict(), train=True).double()
    b64 = {k: v.double() if v.is_floating_point() else v
           for k, v in batch.items()}
    loss_d, g_d = loss_and_grads(m64, b64, dev, f64_versions())
    del m64, b64
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    dist = {'kernels vs plain': grad_dist(g_k, g_p),
            'kernels vs f64': grad_dist(g_k, g_d),
            'plain vs f64': grad_dist(g_p, g_d)}
    ca_grad = math.sqrt(sum(
        float(torch.linalg.vector_norm(g)) ** 2
        for (name, _), g in zip(model.named_parameters(), g_p)
        if name.startswith('context_adaptor.')))
    log(f'adaptor reference: reverb_large + context adaptor f32, B=2, '
        f'{int(batch["cv_list"].shape[0])} phrases, dropout 0.1: every '
        f'kernel call against its plain version, worst share of scale '
        + ', '.join(f'{n} {e:.2e}' for n, e in sorted(errs.items()))
        + f'; loss {loss_k:.6f} vs plain {loss_p:.6f} (rel {loss_rel:.2e}), '
        f'f64 {loss_d:.6f}; gradient distances '
        + ', '.join(f'{n} {d:.2e}' for n, d in dist.items())
        + f'; adaptor gradient norm {ca_grad:.3e}')
    if not (loss_rel <= 1e-5 and ca_grad > 0 and
            dist['kernels vs f64'] <= 2 * dist['plain vs f64']):
        raise AssertionError('adaptor reference: the loss or gradient '
                             'through the kernels differs from the plain '
                             'versions, or no adaptor gradient')
    del model, g_k, g_p, g_d
    torch.cuda.empty_cache()

    model, opt, step = adaptor_model(dev, seed, torch.bfloat16)
    batch = with_cv_list(train_batch(dev, TRAIN_B, seed + 2,
                                     model.cfg.vocab_size), seed + 1)
    ca_before = [p.detach().clone()
                 for p in model.context_adaptor.parameters()]
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    ln_calls, hooks = ln_call_counter(model)
    fa.LAUNCHES = fa.BWD_LAUNCHES = ln.LAUNCHES = ln.BWD_LAUNCHES = 0
    walls, metrics = [], []
    try:
        for _ in range(ADAPTOR_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.append(step(model, batch, gen))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        for h in hooks:
            h.remove()
    launches = {'K1': fa.LAUNCHES, 'K4': fa.BWD_LAUNCHES,
                'K5': ln.LAUNCHES, 'K6': ln.BWD_LAUNCHES}
    n = ADAPTOR_STEPS
    want = {'K1': LAYERS_ENC * n, 'K4': LAYERS_ENC * n,
            'K5': (LN_ENC + LN_DEC) * n, 'K6': (LN_ENC + LN_DEC) * n}
    log(f'adaptor training launches {launches}, expected {want} ({n} bf16 '
        f'steps at B={TRAIN_B}); losses '
        f'{[round(m["loss"], 4) for m in metrics]}, grad norms '
        f'{[round(m["grad_norm"], 3) for m in metrics]}; ms a step '
        f'{[round(w * 1e3, 1) for w in walls]}')
    if launches != want or ln_calls[0] != want['K5']:
        raise AssertionError('adaptor training did not run every kernel the '
                             'expected number of times')
    if not all(math.isfinite(m['loss']) and m['skipped'] == 0.0
               for m in metrics):
        raise AssertionError(f'adaptor training: {metrics}')
    if all(torch.equal(a, p.detach()) for a, p in
           zip(ca_before, model.context_adaptor.parameters())):
        raise AssertionError('adaptor training left the adaptor unchanged')
    share, moved = adaptor_blank_rule(model, batch)
    log(f'adaptor: with the query bias moved by {moved:.3e} (the blank '
        f'term\'s score raised by the median margin), the blank term wins '
        f'on {share:.3f} of the valid frames; the bias is zero on exactly '
        f'those')
    step_ms = sum(walls[1:]) / (n - 1) * 1e3
    del model, opt, step
    torch.cuda.empty_cache()
    return {'launches': launches, 'steps': n, 'step_ms': step_ms,
            'loss_rel': loss_rel, 'call_errs': dict(errs), **dist}


def adaptor_blank_rule(model, batch):
    """The adaptor's "picks blank → zero" rule on the trained model and the
    batch.  Random weights leave the blank term last on every frame, so the
    query bias first moves by the least-norm δ with δ·k_j = 0 for every
    phrase key k_j and δ·k_0 = √dk · the median over the valid frames of
    the margin (best phrase score − blank score): the blank term then wins
    on about half of the frames and loses on the rest, and the rule is
    tested both ways.  The bias must be zero on exactly the frames whose
    attention argmax is the blank term.  Returns (the share of valid frames
    that pick blank, |δ|)."""
    import torch
    from reverb_tpu_torch.models.context_adaptor import combine_layers
    ca = model.context_adaptor
    att = ca.attention
    with torch.no_grad():
        out, mask, layers = model.forward_encoder(
            batch['feats'], batch['feats_lengths'], batch['cat_embs'],
            decoding_chunk_size=0, return_layers=True)
        emb = ca.encode_cv(batch['cv_list'], batch['cv_list_lengths'])
        valid = mask[:, 0]
        q = combine_layers(layers).to(emb.dtype)
        k = att.cross_kv(emb)[0][0, 0].double()            # (N + 1, dk)
        scores = att.linear_q(q).double() @ k.t()           # × √dk
        margin = (scores[..., 1:].amax(-1) - scores[..., 0])[valid]
        target = torch.zeros(k.shape[0], dtype=torch.float64,
                             device=k.device)
        target[0] = margin.median()
        delta = torch.linalg.pinv(k) @ target
        att.linear_q.bias += delta.to(att.linear_q.bias.dtype)
        bias = ca(layers, emb)
        kv = emb.expand(out.shape[0], -1, -1)
        _, attn = att.forward_shared_kv_grouped(
            q, att.cross_kv(kv), None, 1, return_weights=True)
        zero = (bias == 0).all(-1)[valid]
        blank = (torch.argmax(attn[:, 0], -1) == 0)[valid]
    share = float(blank.float().mean())
    if not 0 < share < 1:
        raise AssertionError(f'the adaptor\'s blank term wins on {share} of '
                             f'the frames: the rule is not tested both ways')
    if not torch.equal(zero, blank):
        raise AssertionError('the adaptor\'s bias is not zero exactly where '
                             'the blank term wins')
    return share, float(torch.linalg.vector_norm(delta))


def run_context(dev, asr, wav, feats, audio_s, seed=SEED):
    """Context biasing: K2b against its plain version, biased serving, and
    a deep-biasing model's training steps."""
    t0 = time.perf_counter()
    err, t = check_beam_biased(dev, seed)
    res = {'k2b_err': err, 'k2b': t,
           'serving': run_context_serving(dev, asr, wav, feats, audio_s),
           'adaptor': run_adaptor_training(dev, seed)}
    log(f'context: the phase took {time.perf_counter() - t0:.1f} s; on '
        f'{smi_line()}')
    return res


# ------------------------------ phase 14: the tools ------------------------------

TOOLS_WAVS = 4                        # WAVs of 3-6 s for bin/alignment


def tools_asr(asr, device, tokenizer):
    """A ReverbASR over an f32 copy of asr's weights on `device`."""
    import torch
    from reverb_tpu_torch.cli.reverb import ReverbASR
    from reverb_tpu_torch.models.asr_model import build_model
    sd = {k: v.detach().to('cpu') for k, v in asr.model.state_dict().items()}
    cfg = asr.model.cfg.with_compute_dtype(torch.float32)
    return ReverbASR.from_model(asr.configs, build_model(cfg, device, sd),
                                tokenizer)


def post_wav(port: int, wav: Path) -> dict:
    """POST `wav` as multipart form data to the demo app on 127.0.0.1
    (http.client: no proxy is consulted)."""
    import http.client
    boundary = 'reverbsmokeboundary'
    body = (f'--{boundary}\r\nContent-Disposition: form-data; name="audio";'
            f' filename="{wav.name}"\r\nContent-Type: audio/wav\r\n\r\n'
            ).encode() + wav.read_bytes() + f'\r\n--{boundary}--\r\n'.encode()
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
    try:
        conn.request('POST', '/transcribe', body=body, headers={
            'Content-Type': f'multipart/form-data; boundary={boundary}'})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f'app: HTTP {resp.status}')
        return json.loads(resp.read())
    finally:
        conn.close()


class tools_counter:
    """Context manager around one card-side run of a tool: every launch
    count zeroed on entry and read on exit (`launches`, K2b included), and
    the encoder calls (`n_enc`) and LayerNorm calls on CUDA inputs of a
    shape K5 takes (`ln`) of any model, through global module hooks (the
    tools build their own models).  On exit it asserts K1 = 18 and K5 ≥
    LN_ENC per encoder call, K5 = the LayerNorm calls, and, by `beam`:
    None no beam, 'plain' K2 = K3 ≥ 1 a call and no K2b, 'biased' K2b = K3
    ≥ 1 a call and no K2."""

    def __init__(self, name: str, beam=None):
        self.name, self.beam = name, beam

    def __enter__(self):
        from torch.nn.modules.module import register_module_forward_hook
        from reverb_tpu_torch.models.encoder import ConformerEncoder
        from reverb_tpu_torch.models.modules import LayerNorm
        from reverb_tpu_torch.ops import layer_norm as ln
        self.n_enc = self.ln = 0

        def hook(mod, args, out):
            if isinstance(mod, ConformerEncoder):
                self.n_enc += 1
            elif (isinstance(mod, LayerNorm) and args[0].is_cuda
                  and ln.eligible(args[0])):
                self.ln += 1
        self.handle = register_module_forward_hook(hook)
        zero_launch_counts()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.handle.remove()
        if exc[0] is not None:
            return False
        got = dict(launch_counts(), K2b=k2b_launches())
        n = self.n_enc
        beam = {'K2': 0, 'K3': 0, 'K2b': 0}
        if self.beam == 'plain':
            beam = {'K2': got['K3'], 'K3': max(got['K3'], n), 'K2b': 0}
        elif self.beam == 'biased':
            beam = {'K2': 0, 'K3': max(got['K3'], n), 'K2b': got['K3']}
        want = {'K1': LAYERS_ENC * n, **beam, 'K5': self.ln}
        self.launches = got
        log(f'tools {self.name}: launches {got}, expected {want} ({n} '
            f'encoder calls, {self.ln} LayerNorm calls)')
        if got != want or n < 1 or self.ln < LN_ENC * n:
            raise AssertionError(f'tools {self.name}: the kernels did not '
                                 f'run the expected number of times')
        return False


def run_tools(dev, asr, wav, feats, audio_s, workdir: Path, seed=SEED):
    """The tools on f32 copies of the serving weights, each against the
    same run on the CPU: `bin.alignment` on TOOLS_WAVS WAVs (TextGrids
    byte-equal), `cli.transcribe --align` (JSON equal), plain and
    `--context_path` (text equal, and changed by the context against the
    plain call, at the first context_score of CTX_SCORES that changes it);
    one POST to `cli.app` on 127.0.0.1 (port 0, a thread), answered as
    `transcribe` answers; each card-side run with its launches counted and
    asserted (`tools_counter`); `force_align` timed at T = 512."""
    import contextlib
    import copy
    import io
    import threading
    from http.server import HTTPServer

    import torch
    from reverb_tpu_torch import convert
    from reverb_tpu_torch.bin import alignment
    from reverb_tpu_torch.cli import app, transcribe
    from reverb_tpu_torch.cli import reverb as rv
    from reverb_tpu_torch.decode.api import encode_and_ctc
    from reverb_tpu_torch.decode.ctc_utils import force_align
    from reverb_tpu_torch.text.tokenizer import init_tokenizer
    t_phase = time.perf_counter()
    tdir = workdir / 'tools'
    tdir.mkdir()
    configs = copy.deepcopy(asr.configs)
    configs['dtype'] = 'fp32'
    configs['tokenizer_conf']['split_with_space'] = True
    configs.setdefault('dataset_conf', {}).update({
        'fbank_conf': {'num_mel_bins': 80, 'frame_length': 25,
                       'frame_shift': 10, 'dither': 0.0},
        'batch_conf': {'batch_type': 'static', 'batch_size': 1}})
    tok = init_tokenizer(configs)
    models = {'cuda': tools_asr(asr, dev, tok),
              'cpu': tools_asr(asr, torch.device('cpu'), tok)}
    units = [ln.split()[0] for ln in (workdir / 'units.txt').read_text(
        encoding='utf8').splitlines()[2:-1]]
    rng = np.random.RandomState(seed + 300)
    lines = []
    for i in range(TOOLS_WAVS):
        n = int(rng.uniform(3.0, 6.0) * 16000)
        path = tdir / f'align{i}.wav'
        write_wav(path, n, seed + 310 + i)
        text = ' '.join(rng.choice(units, n // 16000 * 3))
        lines.append(json.dumps({'key': f'utt{i}', 'wav': str(path),
                                 'txt': text, 'style': 'verbatim'}))
    (tdir / 'align.list').write_text('\n'.join(lines) + '\n')
    (tdir / 'config.json').write_text(json.dumps(configs))
    np.savez(tdir / 'model.npz', **convert.flat_from_state_dict(
        models['cpu'].model.state_dict()))
    one = tdir / 'align0.wav'
    label = json.loads(lines[0])['txt']
    # the context phrases: tokens of the WAV's CTC top-k
    phrases = topk_phrases(file_topk(models['cuda'], models[
        'cuda'].compute_feats(str(one))), seed + 320)
    (tdir / 'context.txt').write_text('\n'.join(
        ' '.join(tok.ids2tokens(p)) for p in phrases) + '\n',
        encoding='utf8')
    res, out, counts = {'context_phrases': len(phrases)}, {}, {}

    def timed(key, fn, counter=None):
        t0 = time.perf_counter()
        with counter or contextlib.nullcontext():
            with contextlib.redirect_stdout(io.StringIO()):
                got = fn()
        res[key] = time.perf_counter() - t0
        if counter is not None:
            counts[counter.name] = (counter.launches, counter.n_enc)
        return got

    def align_grids(name):
        alignment.main(['--config', str(tdir / 'config.json'),
                        '--checkpoint', str(tdir / 'model.npz'),
                        '--input_file', str(tdir / 'align.list'),
                        '--result_dir', str(tdir / f'grid_{name}'),
                        '--device', name])
        return {p.name: p.read_bytes() for p in sorted(
            (tdir / f'grid_{name}').glob('*.TextGrid'))}

    def context_argv(score):
        return [str(one), '--context_path', str(tdir / 'context.txt'),
                '--context_score', str(score)]
    argvs = {'align': [str(one), '--align', '--label', label],
             'plain': [str(one)]}
    beams = {'align': None, 'plain': 'plain', 'context': 'biased'}
    for name in ('cuda', 'cpu'):
        card = name == 'cuda'
        base = ['-m', str(tdir), '--device', name]
        out[name] = {'grids': timed(
            f'alignment_{name}_s', lambda: align_grids(name),
            tools_counter('alignment') if card else None)}
        if card and counts['alignment'][1] != TOOLS_WAVS:
            raise AssertionError(f'bin.alignment: {counts["alignment"][1]} '
                                 f'encoder calls for {TOOLS_WAVS} WAVs')
        with swapped({(rv, 'load_model'):
                      lambda *a, name=name, **k: models[name]}):
            for what in ('align', 'plain'):
                out[name][what] = timed(
                    f'transcribe_{what}_{name}_s',
                    lambda: transcribe.main(argvs[what] + base),
                    tools_counter(f'transcribe_{what}', beams[what])
                    if card else None)
            if card:
                # the first context_score that changes the plain output
                for score in CTX_SCORES:
                    argvs['context'] = context_argv(score)
                    got = timed('transcribe_context_cuda_s',
                                lambda: transcribe.main(argvs['context']
                                                        + base),
                                tools_counter('transcribe_context',
                                              'biased'))
                    if got != out[name]['plain']:
                        break
                else:
                    raise AssertionError(f'transcribe --context_path changed '
                                         f'nothing at context_score '
                                         f'{CTX_SCORES}')
                res['context_score'] = score
                out[name]['context'] = got
            else:
                out[name]['context'] = timed(
                    'transcribe_context_cpu_s',
                    lambda: transcribe.main(argvs['context'] + base))
    grids = out['cuda']['grids']
    if len(grids) != TOOLS_WAVS or grids != out['cpu']['grids']:
        raise AssertionError('bin.alignment: the TextGrids on the card '
                             'differ from the CPU run\'s')
    for what in ('align', 'context', 'plain'):
        if out['cuda'][what] != out['cpu'][what]:
            raise AssertionError(f'transcribe ({what}): the card\'s output '
                                 f'differs from the CPU run\'s')
    n_tok = len(out['cuda']['align']['tokens'])
    if n_tok != len(label.split()) or not all(
            0 <= t['start'] <= t['end'] for t in out['cuda']['align'][
                'tokens']):
        raise AssertionError('transcribe --align: bad token times')

    # the demo app: one POST on 127.0.0.1, port 0, served from a thread
    server = HTTPServer(('127.0.0.1', 0), app.make_handler(
        models['cuda'], 'ctc_prefix_beam_search'))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        reply = timed('app_s', lambda: post_wav(server.server_address[1],
                                                one),
                      tools_counter('app_post', 'plain'))
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=30)
    if th.is_alive():
        raise AssertionError('the demo app\'s thread did not stop')
    want = models['cuda'].transcribe(str(one), mode='ctc_prefix_beam_search')
    if reply != {'text': want}:
        raise AssertionError(f'app reply {reply!r} != {{"text": {want!r}}}')

    # force_align at T = 512 on the card
    m = models['cuda']
    x = feats[None, :CHUNK].float()
    with torch.inference_mode():
        _, lens, probs = encode_and_ctc(m.model, x,
                                        torch.tensor([CHUNK], device=dev),
                                        torch.tensor([1.0, 0.0], device=dev))
    T = int(lens[0])
    y = [int(u) for u in rng.randint(2, VOCAB - 1, T // 5)]
    ali = force_align(probs[0, :T], y, 0)
    if len(ali) != T or ali != force_align(probs[0, :T].cpu(), y, 0):
        raise AssertionError('force_align on the card differs from the CPU')
    res['force_align_ms'] = cuda_time_ms(
        lambda: force_align(probs[0, :T], y, 0), 3)
    res['force_align_T'], res['force_align_L'] = T, len(y)
    res['launches'] = counts
    log(f'tools: bin.alignment on {TOOLS_WAVS} WAVs {res["alignment_cuda_s"]:.2f} '
        f's on the card ({res["alignment_cpu_s"]:.2f} s on the CPU), '
        f'TextGrids byte-equal; transcribe --align ({n_tok} tokens), '
        f'--context_path ({len(phrases)} distinct phrases, context_score '
        f'{res["context_score"]}) and plain equal to the CPU run; app POST '
        f'{res["app_s"]:.3f} s, reply equal to transcribe; force_align at '
        f'T={T}, L={len(y)}: {res["force_align_ms"]:.2f} ms per call (equal '
        f'to the CPU); the phase took {time.perf_counter() - t_phase:.1f} s; '
        f'on {smi_line()}')
    del models
    torch.cuda.empty_cache()
    return res


# ------------------------------ phase 15: checkpointing and the training options ------------------------------

REMAT_B, REMAT_BIG_B = 8, 32     # utterances of 1600-2051 frames a step
REMAT_RUNS = (('off', None), ('full', 'full'), ('dots', 'dots'))
REMAT_STEPS = 2                  # a step, then the timed one
# K1 a step: once per encoder layer, again in the replay under 'full'
REMAT_K1 = {'off': LAYERS_ENC, 'full': 2 * LAYERS_ENC, 'dots': LAYERS_ENC}


def kernel_counts() -> dict:
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    return {'K1': fa.LAUNCHES, 'K4': fa.BWD_LAUNCHES, 'K5': ln.LAUNCHES,
            'K6': ln.BWD_LAUNCHES}


def set_remat(model, policy, **changes):
    """Point the model's configs at gradient checkpointing under `policy`
    (None: off), with `changes` to its ModelConfig."""
    import dataclasses as dc
    flags = {'gradient_checkpointing': policy is not None,
             'remat_policy': policy or 'dots'}
    enc = dc.replace(model.cfg.encoder, **flags)
    dec = dc.replace(model.cfg.decoder, **flags)
    model.cfg = dc.replace(model.cfg, encoder=enc, decoder=dec, **changes)
    model.encoder.cfg = enc
    for d in (model.decoder, model.decoder.left_decoder,
              model.decoder.right_decoder):
        d.cfg = dec


def sharpen_for_filter(model, batch):
    """The CTC head ×8 with its blank bias at the median of (best
    non-blank − blank) over the batch's valid frames, so that about half
    the frames survive the non-blank filter.  Returns that share."""
    import torch
    from reverb_tpu_torch.models.asr_model import filter_blank_embedding
    from reverb_tpu_torch.models.ctc import ctc_logprobs
    lo = model.ctc.ctc_lo
    with torch.no_grad():
        lo.weight.mul_(8.0)
        lo.bias.zero_()
        enc, mask = model.forward_encoder(batch['feats'],
                                          batch['feats_lengths'],
                                          batch['cat_embs'])
        logits = lo(enc).float()
        gap = (logits[..., 1:].amax(-1) - logits[..., 0])[mask[:, 0]]
        lo.bias[0] = gap.median()
        _, kept = filter_blank_embedding(model.cfg, ctc_logprobs(
            model.ctc, enc), enc, mask)
    return float(kept.sum()) / float(mask.sum())


def remat_run(model, init, configs, batch, dev, seed, policy, what,
              **changes):
    """REMAT_STEPS make_train_step steps of `model` from the weights
    `init` (host copies) with a fresh optimizer of `configs`, under
    `policy`: (ms of the last step, first step ms, peak GiB, launches a
    step, metrics)."""
    import gc
    import torch
    from reverb_tpu_torch.train.trainer import (TrainConfig,
                                                build_optimizer,
                                                make_train_step)
    with torch.no_grad():
        for p, w in zip(model.parameters(), init):
            p.copy_(w)
    set_remat(model, policy, **changes)
    kept = None
    if changes.get('apply_non_blank_embedding'):
        kept = sharpen_for_filter(model, batch)
    tc = TrainConfig.from_config(configs)
    opt, _ = build_optimizer(tc, model)
    step = make_train_step(model.cfg, opt, tc.accum_grad, tc.grad_clip)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    diar_zero_launch_counts()
    walls, metrics = [], []
    for _ in range(REMAT_STEPS):
        t0 = time.perf_counter()
        metrics.append(step(model, batch, gen))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = {k: v / REMAT_STEPS for k, v in kernel_counts().items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del opt, step
    gc.collect()
    torch.cuda.empty_cache()
    for m in metrics:
        if not (math.isfinite(m['loss']) and m['skipped'] == 0.0):
            raise AssertionError(f'remat {what}: step {m}')
    log(f'remat {what}: B={batch["feats"].shape[0]}, {walls[-1] * 1e3:.1f} '
        f'ms/step (first {walls[0] * 1e3:.1f}), peak {peak:.2f} GiB, '
        f'launches a step {launches}, losses '
        f'{[round(m["loss"], 4) for m in metrics]}'
        + ('' if kept is None else f'; {kept:.3f} of the frames survive '
           f'the non-blank filter'))
    return {'ms': walls[-1] * 1e3, 'first_ms': walls[0] * 1e3,
            'peak_gib': peak, 'launches': launches,
            'loss': metrics[-1]['loss'], 'kept': kept}


def remat_steps(dev, seed) -> dict:
    """reverb_large in bf16 (f32 master weights, dropout 0.1, Adam,
    warmuplr, clip 50), one model: each checkpointing policy at B = 8 and
    B = 32 from the same weights and generator seed, then novograd, Adam
    with a bf16 first moment, and the non-blank-embedding loss (Adam, no
    checkpointing).  K1 and K4 a step asserted."""
    import gc
    import torch
    from reverb_tpu_torch.models import presets
    configs = presets.reverb_large()
    model, opt, step = train_model(dev, seed, torch.bfloat16)
    del opt, step
    init = [p.detach().to('cpu', copy=True) for p in model.parameters()]
    res = {}
    for B in (REMAT_B, REMAT_BIG_B):
        batch = train_batch(dev, B, seed + 2, model.cfg.vocab_size)
        for name, policy in REMAT_RUNS:
            r = remat_run(model, init, configs, batch, dev, seed, policy,
                          f'{name} at B={B}')
            want = {'K1': REMAT_K1[name], 'K4': LAYERS_ENC}
            got = {k: r['launches'][k] for k in want}
            if got != want:
                raise AssertionError(f'remat {name} at B={B}: launches a '
                                     f'step {got}, expected {want}')
            res[f'{name}_b{B}'] = r
        del batch
    batch = train_batch(dev, REMAT_B, seed + 2, model.cfg.vocab_size)
    novograd = dict(configs, optim='novograd')
    mu = dict(configs, optim_conf=dict(configs['optim_conf'],
                                       mu_dtype='bfloat16'))
    for name, conf, changes in (
            ('novograd', novograd, {}), ('adam_mu_bf16', mu, {}),
            ('non_blank_embedding', configs,
             {'apply_non_blank_embedding': True})):
        r = remat_run(model, init, conf, batch, dev, seed, None, name,
                      **changes)
        if r['launches']['K1'] != LAYERS_ENC or \
                r['launches']['K4'] != LAYERS_ENC:
            raise AssertionError(f'remat {name}: launches {r["launches"]}')
        res[name] = r
    del model, init, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def grad_worst(ga, gb, names) -> tuple:
    """(worst per-tensor ‖ga − gb‖ / ‖gb‖ with each norm floored at 1e-4
    of the global one, its tensor, the global distance)."""
    import torch
    norm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in gb])))
    worst, where = 0.0, ''
    for n, a, b in zip(names, ga, gb):
        r = float(torch.linalg.vector_norm(a - b)) / max(
            float(torch.linalg.vector_norm(b)), 1e-4 * norm)
        if r > worst:
            worst, where = r, n
    return worst, where, grad_dist(ga, gb)


def remat_reference_check(dev, seed) -> dict:
    """reverb_large in f32 (TF32 off), B = 2, dropout 0.1 from a generator
    of seed 7: the gradients with checkpointing off (twice: the run-to-run
    floor), under 'full' and under 'dots', each against the first; then
    one 'full' and one 'dots' step with every K1/K4/K5/K6 call held to its
    plain version on that call's inputs (`checked_kernels`)."""
    import gc
    import torch
    model, opt, step = train_model(dev, seed, torch.float32)
    del opt, step
    names = [n for n, _ in model.named_parameters()]
    batch = train_batch(dev, 2, seed + 1, model.cfg.vocab_size)
    runs = {}
    for name, policy in (('off', None), ('off again', None), ('full', 'full'),
                         ('dots', 'dots')):
        set_remat(model, policy)
        diar_zero_launch_counts()
        loss, g = loss_and_grads(model, batch, dev)
        runs[name] = (loss, g, kernel_counts())
    loss0, g0, _ = runs['off']
    res = {'launches': {n: r[2] for n, r in runs.items()}}
    for name in ('off again', 'full', 'dots'):
        worst, where, glob = grad_worst(runs[name][1], g0, names)
        res[name] = {'loss_rel': abs(runs[name][0] - loss0) / abs(loss0),
                     'worst': worst, 'worst_tensor': where, 'global': glob}
    floor = max(4 * res['off again']['worst'], 1e-5)
    log(f'remat reference: reverb_large f32, B=2, dropout 0.1: gradients '
        f'against checkpointing off — '
        + '; '.join(f'{n}: loss rel {r["loss_rel"]:.2e}, worst tensor '
                    f'{r["worst"]:.2e} ({r["worst_tensor"]}), global '
                    f'{r["global"]:.2e}'
                    for n, r in res.items() if n != 'launches')
        + f'; launches {res["launches"]}')
    for name in ('full', 'dots'):
        if not (res[name]['worst'] <= floor
                and res[name]['loss_rel'] <= 1e-6):
            raise AssertionError(f'remat reference: {name} differs from '
                                 f'checkpointing off beyond the floor '
                                 f'{floor:.2e}')
    if any(runs[n][2]['K1'] != REMAT_K1[n.split()[0]] for n in runs):
        raise AssertionError(f'remat reference: K1 {res["launches"]}')
    del runs, g0
    for policy in ('full', 'dots'):
        set_remat(model, policy)
        errs = {}
        loss_and_grads(model, batch, dev, checked_kernels(errs))
        check_call_errs(errs, f'remat reference, {policy}')
        res[f'call_errs_{policy}'] = dict(errs)
        log(f'remat reference: {policy}, every kernel call against its '
            f'plain version, worst share of scale '
            + ', '.join(f'{n} {e:.2e}' for n, e in sorted(errs.items())))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_remat(dev, seed=SEED):
    """Gradient checkpointing at reverb_large width (the three policies at
    B = 8 and 32, and against the plain versions in f32), steps through
    novograd, a bf16 first moment and the non-blank-embedding loss, and
    bin.train with dataset_conf.device_feats on the recipe corpus."""
    t_phase = time.perf_counter()
    res = {'reference': remat_reference_check(dev, seed),
           'steps': remat_steps(dev, seed)}
    with tempfile.TemporaryDirectory(prefix='reverb_remat_') as tmp:
        workdir = Path(tmp)
        recipe_corpus(workdir, seed + 70)
        res['device_feats'] = recipe_train(dev, workdir, seed,
                                           device_feats=True)
    log(f'remat: the phase took {time.perf_counter() - t_phase:.1f} s; on '
        f'{smi_line()}')
    return res


# ------------------------------ phase 16: diarization training ------------------------------

DT_MIN, DT_HELD_MIN = 20.0, 5.0     # training and held-out corpora
DT_EMB_B, DT_EMB_BATCHES, DT_EMB_EPOCHS = 64, 20, 20
DT_SEG_B, DT_SEG_STEPS = 8, 10
DT_CROP = 32000                     # 2 s embedding crops


def single_speaker_turns(turns):
    """The turns no other turn overlaps, (start s, end s, speaker)."""
    out = []
    for i, (s, e, spk) in enumerate(turns):
        if all(e2 <= s or s2 >= e for j, (s2, e2, _) in enumerate(turns)
               if j != i):
            out.append((s, e, spk))
    return out


def embedding_batches(audio, turns, dev, seed):
    """DT_EMB_BATCHES batches of DT_EMB_B 2 s crops inside single-speaker
    turns, as the Diarizer embeds them (fbank of the wave × 2¹⁵): (feats
    (B, T, 80), lens (B,), speakers (B,)) on the device."""
    import torch
    from reverb_tpu_torch.frontend.fbank import (FbankConfig,
                                                 compute_fbank_batch,
                                                 num_frames)
    rng = np.random.RandomState(seed)
    pool = [(int(s * 16000), int(e * 16000), spk)
            for s, e, spk in single_speaker_turns(turns)
            if (e - s) * 16000 > DT_CROP]
    wave = torch.from_numpy(audio).to(dev)
    n = num_frames(DT_CROP)
    out = []
    for _ in range(DT_EMB_BATCHES):
        pick = [pool[i] for i in rng.randint(len(pool), size=DT_EMB_B)]
        starts = torch.tensor([rng.randint(s, e - DT_CROP + 1)
                               for s, e, _ in pick], device=dev)
        rows = wave[starts[:, None] + torch.arange(DT_CROP, device=dev)]
        feats = compute_fbank_batch(rows * (1 << 15), FbankConfig(), n)
        out.append((feats, torch.full((DT_EMB_B,), n, device=dev),
                    torch.tensor([spk for _, _, spk in pick], device=dev)))
    return out


def segmentation_batches(seg, audio, turns, dev, seed):
    """DT_SEG_STEPS batches of DT_SEG_B 10 s windows with one-hot powerset
    labels at the net's frame rate (speakers numbered by first appearance
    in the window, at most 3, at most 2 at once): (wave (B, S), labels
    (B, T', 7)) on the device."""
    import torch
    from reverb_tpu_torch.diar.models import powerset_classes
    cfg = seg.cfg
    classes = {c: i for i, c in enumerate(powerset_classes(
        cfg.max_speakers, cfg.max_simultaneous))}
    S = 160000
    with torch.inference_mode():
        T = seg(torch.zeros((1, S), device=dev)).shape[1]
    hop = cfg.sinc_stride * cfg.pool
    centre = (np.arange(T) * hop + (hop + cfg.sinc_kernel) / 2) / 16000
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(DT_SEG_STEPS):
        waves, labels = [], []
        for start in rng.randint(0, len(audio) - S, DT_SEG_B):
            t = start / 16000 + centre
            near = [x for x in turns if x[1] > t[0] and x[0] <= t[-1]]
            local, lab = {}, np.zeros((T, len(classes)), np.float32)
            for i, ti in enumerate(t):
                active = []
                for s, e, spk in near:
                    if s <= ti < e:
                        if spk not in local and len(local) < cfg.max_speakers:
                            local[spk] = len(local)
                        if spk in local:
                            active.append(local[spk])
                lab[i, classes[tuple(sorted(active)[:cfg.max_simultaneous])]] \
                    = 1.0
            waves.append(audio[start:start + S])
            labels.append(lab)
        out.append((torch.from_numpy(np.stack(waves)).to(dev),
                    torch.from_numpy(np.stack(labels)).to(dev)))
    return out


def recorded(fn, losses):
    """fn, with the float of each loss it returns appended to `losses`."""
    def wrapper(*a, **k):
        loss, aux = fn(*a, **k)
        losses.append(float(loss.detach()))
        return loss, aux
    return wrapper


def diar_clusters(seg, emb, audio, dev) -> int:
    from reverb_tpu_torch.diar.pipeline import Diarizer
    return len({s.speaker for s in Diarizer(seg, emb, device=dev)(audio,
                                                                  16000)})


def run_diartrain(dev, seed=SEED):
    """The native nets at full width (f32): train_embedding on
    DT_EMB_EPOCHS × DT_EMB_BATCHES steps of 2 s single-speaker crops of a
    DT_MIN-minute corpus of DIAR_SPK confusable speakers (K5 and K6 at the
    TDNN's 512-channel LayerNorms a step; K6 > 0 asserted), and
    train_segmentation on DT_SEG_STEPS batches of 10 s windows; the loss
    before and after; one embedding step with every K5/K6 call held to its
    plain version; the clusters the Diarizer finds on a held-out
    DT_HELD_MIN minutes with the trained embedding net and with the random
    one (reported, not gated)."""
    import copy
    import torch
    from reverb_tpu_torch.diar import train_embedding as tte
    from reverb_tpu_torch.diar import train_segmentation as tts
    t_phase = time.perf_counter()
    audio, turns = diar_corpus(DT_MIN, DIAR_SPK, seed + 80, DIAR_OVERLAP)
    held, _ = diar_corpus(DT_HELD_MIN, DIAR_SPK, seed + 81, DIAR_OVERLAP)
    seg, emb = diar_routes(dev, seed)['native']
    emb_random = copy.deepcopy(emb)
    ebatches = embedding_batches(audio, turns, dev, seed + 82)
    sbatches = segmentation_batches(seg, audio, turns, dev, seed + 83)
    res = {}
    e_losses, s_losses = [], []
    torch.cuda.synchronize()
    diar_zero_launch_counts()
    t0 = time.perf_counter()
    with swapped({(tte, 'embedding_loss'): recorded(tte.embedding_loss,
                                                    e_losses)}):
        tte.train_embedding(emb, DIAR_SPK, lambda: ebatches,
                            max_epochs=DT_EMB_EPOCHS, margin=0.2,
                            seed=seed + 84)
    torch.cuda.synchronize()
    n = DT_EMB_EPOCHS * DT_EMB_BATCHES
    wall = time.perf_counter() - t0
    res['embedding'] = {'steps': n, 'ms': wall / n * 1e3,
                        'launches': {k: v / n for k, v in
                                     kernel_counts().items()},
                        'loss_first': e_losses[0],
                        'loss_last': float(np.mean(e_losses[-DT_EMB_BATCHES:]))}
    if not res['embedding']['launches']['K6'] > 0:
        raise AssertionError('diartrain: K6 did not launch on the embedding '
                             'backward')
    diar_zero_launch_counts()
    t0 = time.perf_counter()
    with swapped({(tts, 'segmentation_loss'): recorded(
            tts.segmentation_loss, s_losses)}):
        tts.train_segmentation(seg, lambda: sbatches, max_epochs=1,
                               lr=1e-3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res['segmentation'] = {'steps': DT_SEG_STEPS,
                           'ms': wall / DT_SEG_STEPS * 1e3,
                           'launches': {k: v / DT_SEG_STEPS for k, v in
                                        kernel_counts().items()},
                           'loss_first': s_losses[0],
                           'loss_last': s_losses[-1]}
    for part in ('embedding', 'segmentation'):
        r = res[part]
        if not all(math.isfinite(x) for x in (r['loss_first'],
                                              r['loss_last'])):
            raise AssertionError(f'diartrain {part}: {r}')
        log(f'diartrain {part}: {r["steps"]} steps, {r["ms"]:.2f} ms a '
            f'step, launches a step {r["launches"]}, loss {r["loss_first"]:.4f} '
            f'→ {r["loss_last"]:.4f}')
    # one embedding step, every K5/K6 call against its plain version
    errs = {}
    feats, lens, labels = ebatches[0]
    with swapped(checked_kernels(errs)):
        emb.train().requires_grad_(True)
        head = torch.randn((DIAR_SPK, emb.cfg.embed_dim), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               seed)) * 0.1
        loss, _ = tte.embedding_loss(emb, head, feats, lens, labels,
                                     margin=0.2)
        loss.backward()
        torch.cuda.synchronize()
        emb.eval().requires_grad_(False)
        for p in emb.parameters():
            p.grad = None
    bad = {k: e for k, e in errs.items()
           if not e <= RECIPE_CALL_TOL[k.split()[0]]}
    if bad or {k.split()[0] for k in errs} != {'K5', 'K6'}:
        raise AssertionError(f'diartrain: K5/K6 against their plain '
                             f'versions {errs}')
    res['call_errs'] = errs
    log('diartrain: one embedding step, every K5/K6 call against its plain '
        'version, worst share of scale '
        + ', '.join(f'{k} {e:.2e}' for k, e in sorted(errs.items())))
    diar_bias_off_silence(seg, held, dev, 'native (trained)')
    res['clusters_trained'] = diar_clusters(seg, emb, held, dev)
    res['clusters_random'] = diar_clusters(seg, emb_random, held, dev)
    log(f'diartrain: the Diarizer on a held-out {DT_HELD_MIN:.0f} min '
        f'({DIAR_SPK} speakers): {res["clusters_trained"]} clusters with the '
        f'trained embedding net, {res["clusters_random"]} with the random '
        f'one; the phase took {time.perf_counter() - t_phase:.1f} s; on '
        f'{smi_line()}')
    del seg, emb, emb_random, ebatches, sbatches
    torch.cuda.empty_cache()
    return res


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


def f64_versions():
    """LayerNorm and rel-pos attention computed in their input's dtype, as
    module attributes to swap in (the plain versions compute in f32): the
    f64 yardstick of `recipe_reference_check`."""
    import torch
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln

    def layer_norm(x, weight, bias, eps):
        return torch.nn.functional.layer_norm(
            x, (x.shape[-1],), weight.to(x.dtype), bias.to(x.dtype), eps)

    def attention(q, k, v, pos, u, vb, kv_lens, mask=None, rate=0.0):
        Tk = k.shape[2]
        u, vb = (t.to(q.dtype)[None, :, None, :] for t in (u, vb))
        scores = ((q + u) @ k.transpose(-1, -2) + (q + vb) @ pos[
            :, :, :Tk].to(q.dtype).transpose(-1, -2)) / math.sqrt(q.shape[-1])
        valid = (torch.arange(Tk, device=q.device)[None, :]
                 < kv_lens[:, None])[:, None, None, :]
        attn = torch.softmax(scores.masked_fill(~valid, fa._MASK_VALUE),
                             -1).masked_fill(~valid, 0.0)
        if mask is not None and rate > 0.0:
            attn = torch.where(mask != 0, attn / (1.0 - rate),
                               torch.zeros((), dtype=q.dtype,
                                           device=q.device))
        return attn @ v
    return {(fa, 'rel_pos_attention'): attention,
            (ln, 'layer_norm_plain'): layer_norm}


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


def loss_and_grads(model, batch, dev, table=None):
    """(loss, [gradient of each parameter]) of compute_loss + backward on
    `batch`, with the module attributes of `table` swapped in and dropout
    from a generator of seed 7 (two calls draw the same masks)."""
    import torch
    from reverb_tpu_torch.models.asr_model import compute_loss
    with swapped(table or {}):
        for p in model.parameters():
            p.grad = None
        out = compute_loss(model, batch,
                           torch.Generator(device=dev).manual_seed(7))
        out['loss'].backward()
        torch.cuda.synchronize()
        grads = [p.grad.detach().clone() if p.grad is not None
                 else torch.zeros_like(p) for p in model.parameters()]
    for p in model.parameters():
        p.grad = None
    return float(out['loss'].detach()), grads


def grad_dist(ga, gb) -> float:
    """‖ga − gb‖ / ‖gb‖ over all the parameters' gradients (f64 sums)."""
    import torch
    diff = torch.stack([torch.linalg.vector_norm(a.double() - b.double())
                        for a, b in zip(ga, gb)])
    norm = torch.stack([torch.linalg.vector_norm(b.double()) for b in gb])
    return float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(
        norm))


def train_reference_check(dev, seed):
    """reverb_large in f32 (TF32 off), B = 2, dropout on: one loss +
    backward through the kernels and one through the plain versions, with
    generators of the same seed, so the dropout draws match.  The loss
    within 1e-5 relative; every gradient tensor within 1e-3 of its norm
    (norms floored at 1e-4 of the global norm: the rel-pos key biases have
    a gradient that is rounding noise, exactly 0 in exact arithmetic), the
    global gradient within 1e-4."""
    import torch
    model, _, _ = train_model(dev, seed, torch.float32)
    batch = train_batch(dev, 2, seed + 1, model.cfg.vocab_size)
    loss_k, g_k = loss_and_grads(model, batch, dev)
    loss_p, g_p = loss_and_grads(model, batch, dev, plain_versions())
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    norm_p = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in g_p])))
    glob = grad_dist(g_k, g_p)
    worst, worst_name = 0.0, ''
    for (name, _), a, b in zip(model.named_parameters(), g_k, g_p):
        r = float(torch.linalg.vector_norm(a - b)) / max(
            float(torch.linalg.vector_norm(b)), 1e-4 * norm_p)
        if r > worst:
            worst, worst_name = r, name
    log(f'train reference: reverb_large f32, B=2, dropout 0.1, kernels vs '
        f'plain: loss {loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.2e}); '
        f'gradient rel err global {glob:.2e}, worst tensor '
        f'{worst:.2e} ({worst_name})')
    if not (loss_rel <= 1e-5 and glob <= 1e-4 and worst <= 1e-3):
        raise AssertionError('train reference: kernels differ from the plain '
                             'versions')
    del model, g_k, g_p
    torch.cuda.empty_cache()
    return loss_rel, glob, worst


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


def busy_union(spans) -> float:
    """Length of the union of sorted (start, end) intervals."""
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return busy + (0.0 if cur is None else cur[1] - cur[0])


def profile_calls(fn, n: int) -> dict:
    """n calls of fn() under torch.profiler (CPU and CUDA): per call, the
    wall ms, the device busy ms (the union of device events), the device
    events, and the host operators with the most self CPU time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    return {'wall_ms': wall, 'busy_ms': busy_union(spans) / 1e3 / n,
            'device_events': len(spans) / n,
            'host_ops': {a.key: (a.self_cpu_time_total / 1e3 / n, a.count / n)
                         for a in ops[:8]}}


def profile_line(what: str, prof: dict) -> str:
    return (f'{what} profiled: {prof["wall_ms"]:.2f} ms wall, device busy '
            f'{prof["busy_ms"]:.2f} ms, {prof["device_events"]:.0f} device '
            f'events; host self ms (calls): '
            + ', '.join(f'{k} {ms:.2f} ({c:.0f})'
                        for k, (ms, c) in prof['host_ops'].items()))


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
    busy = busy_union(spans)
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


# ------------------------------ phase 17: int8 serving ------------------------------

class site_forcing:
    """Context manager over the int8 products of ops/quant.py.  'record'
    keeps each call's activation input, in call order; 'force' feeds the
    recorded inputs, in the same order, in place of the run's own, after
    comparing the two (`worst`: the largest difference).  A forced run
    of the plain versions thus differs from the recorded kernel run only
    by what the kernels do between two int8 sites: an f32 difference of
    1e-6 that puts an activation on an int8 rounding boundary would
    otherwise move its product by a whole quantization step, and 18
    layers amplify such steps."""

    def __init__(self, mode: str, recorded=None):
        self.mode = mode
        self.recorded = [] if recorded is None else recorded
        self.calls = 0
        self.worst = 0.0

    def _wrap(self, orig):
        def call(x, *args, **kwargs):
            if self.mode == 'record':
                self.recorded.append(x)
            else:
                want = self.recorded[self.calls]
                if want.shape != x.shape:
                    raise AssertionError('int8 sites ran in another order')
                self.worst = max(self.worst, float(
                    (x.float() - want.float()).abs().max()))
                x = want
            self.calls += 1
            return orig(x, *args, **kwargs)
        return call

    def __enter__(self):
        from reverb_tpu_torch.ops import quant
        self.swap = swapped({(quant, n): self._wrap(getattr(quant, n))
                             for n in ('int8_matmul', 'int8_matmul_static',
                                       'int8_conv2d')})
        self.swap.__enter__()
        return self

    def __exit__(self, *exc):
        return self.swap.__exit__(*exc)


def check_int_mm(dev, qmodel, feats):
    """The int32 accumulators of the int8 path on the card (`_int_mm`,
    padded to its shape rules; the conv as im2col) against an int64 CPU
    product of the same int8 operands, exactly: a q projection at 4096 ×
    1024 (the 8-chunk batch), the decoder output layer at N = 10000, 16
    rows (a streaming chunk at B = 1, padded to 17), and the first
    subsampling conv (K = 9, padded to 16) on one chunk.  Also the int8
    GEMM's time beside the bf16 one at the q projection's shape."""
    import torch
    from reverb_tpu_torch.ops import quant
    g = torch.Generator(device=dev).manual_seed(SEED)
    wq = qmodel.encoder.encoders[0].self_attn.linear_q.weight_q8
    wo = qmodel.decoder.left_decoder.output_layer.weight_q8
    xq = quant.quantize_rows(torch.randn(4096, 1024, generator=g,
                                         device=dev))[0]
    hq = quant.quantize_rows(torch.randn(640, 1024, generator=g,
                                         device=dev))[0]
    cases = [('q projection 4096x1024x1024', xq, wq),
             ('decoder output_layer 640x1024x10000', hq, wo),
             ('16 rows (padded to 17) x1024x1024', xq[:16], wq)]
    out = {}
    for name, a, w in cases:
        got = quant.matmul_acc(a, w)
        want = a.cpu().long() @ w.cpu().long().t()
        if got.dtype != torch.int32 or not torch.equal(got.cpu().long(),
                                                         want):
            raise AssertionError(f'_int_mm {name}: not the int64 product')
        out[name] = 0
    w0 = qmodel.encoder.embed.conv['0'].weight_q8
    x = feats[:CHUNK].float()[None, None]
    s = torch.clamp(x.abs().amax((1, 2, 3), keepdim=True), min=1e-8) / 127
    cq = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    got = quant.conv_acc(cq, w0, (2, 2))
    p = cq.cpu().long().unfold(2, 3, 2).unfold(3, 3, 2)
    Ho, Wo = p.shape[2], p.shape[3]
    want = (p.permute(0, 2, 3, 1, 4, 5).reshape(Ho * Wo, 9)
            @ w0.cpu().long().reshape(-1, 9).t())
    want = want.reshape(1, Ho, Wo, -1).permute(0, 3, 1, 2)
    if not torch.equal(got.cpu().long(), want):
        raise AssertionError('int8 conv (im2col + _int_mm): not the int64 '
                             'product')
    out[f'embed.conv.0 on a chunk ({Ho * Wo}x9(16)x1024)'] = 0
    xb = torch.randn(4096, 1024, generator=g, device=dev,
                     dtype=torch.bfloat16)
    wb = torch.randn(1024, 1024, generator=g, device=dev,
                     dtype=torch.bfloat16)
    t_int8 = cuda_time_ms(lambda: quant.int_mm(xq, wq), 50)
    t_bf16 = cuda_time_ms(lambda: torch.nn.functional.linear(xb, wb), 50)
    log(f'int8: _int_mm int32 accumulators equal the int64 CPU product at '
        f'{sorted(out)}; at 4096x1024x1024 int_mm {t_int8:.4f} ms, bf16 '
        f'F.linear {t_bf16:.4f} ms')
    return {'cases': sorted(out), 'int_mm_ms': t_int8, 'bf16_mm_ms': t_bf16}


def int8_reference_check(qasr, feats, dev):
    """The serve phase's reference check on the int8 model in f32 (TF32
    off), the plain versions' run fed each int8 site's input from the
    kernels' run (`site_forcing`): one chunk's encoder within 1e-3, then
    the decode tail (CTC top-k → beam → rescoring) on the SAME encoder
    output, tokens, times and choices identical and scores within 1e-4.
    The unforced plain encoder's difference is reported beside it."""
    import torch
    from reverb_tpu_torch.decode import api
    from reverb_tpu_torch.models.asr_model import build_model
    from reverb_tpu_torch.ops import beam_scan as bs
    model = qasr.model
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
    with site_forcing('record') as rec:
        enc_k = run(True, encode)
    free = float((run(False, encode)[0] - enc_k[0]).abs().max())
    with site_forcing('force', rec.recorded) as forced:
        enc_p = run(False, encode)
    err = float((enc_k[0] - enc_p[0]).abs().max())
    if forced.calls != len(rec.recorded) or not err <= 1e-3 or \
            not forced.worst <= 1e-3:
        raise AssertionError(f'int8 f32 encoder: kernel vs plain err {err}, '
                             f'at the int8 sites {forced.worst}')

    def tail():
        return api._beam_rescore_tail(f32, enc_k[2], enc_k[3], enc_k[4],
                                      enc_k[0], enc_k[1], 10, 0.1, 0.0, 0.0,
                                      256, cat)
    with site_forcing('record') as rec_t:
        beam_k, resc_k = run(True, tail)
    with site_forcing('force', rec_t.recorded) as forced_t:
        beam_p, resc_p = run(False, tail)
    for g, w in zip(beam_k + resc_k, beam_p + resc_p):
        if w.dtype.is_floating_point:
            ok = torch.allclose(g, w, rtol=0, atol=1e-4, equal_nan=True)
        else:
            ok = torch.equal(g, w)
        if not ok or forced_t.calls != len(rec_t.recorded):
            raise AssertionError('int8 f32 decode tail: kernels differ from '
                                 'the plain versions')
    log(f'int8 reference: f32 one chunk, kernels vs plain with each int8 '
        f'site fed the kernel run\'s input ({len(rec.recorded)} encoder and '
        f'{len(rec_t.recorded)} decode-tail sites; largest input difference '
        f'there {max(forced.worst, forced_t.worst)}): encoder max abs err '
        f'{err}; decode tail tokens, times and choices identical, scores '
        f'within 1e-4 ({int(beam_k[1][0, 0])} tokens in the best hyp); '
        f'unforced, the encoder differs by {free} (rounding-boundary steps)')
    del f32, rec, rec_t
    torch.cuda.empty_cache()
    return {'enc_err': err, 'site_err': max(forced.worst, forced_t.worst),
            'enc_err_unforced': free}


def served_call(asr, wav):
    """One transcribe_modes(MODES) call, timed, with its DecodeResults and
    the peak device memory over it: (seconds, CTMs, results, peak
    bytes)."""
    import torch
    from reverb_tpu_torch.cli import reverb as rv
    captured = []
    decode_fn = rv.decode_modes_fn

    def recording_decode(*args, **kwargs):
        out = decode_fn(*args, **kwargs)
        captured.append(out)
        return out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with swapped({(rv, 'decode_modes_fn'): recording_decode}):
        wall, out = transcribe_s(asr, wav, MODES)
    return wall, out, captured, torch.cuda.max_memory_allocated()


def hyp_tokens(results) -> list:
    return [r.tokens for res in results for mode in MODES
            for r in res[mode]]


def run_int8(dev, asr, wav, feats, audio_s):
    """`--quantize int8` serving at reverb_large width (bf16 compute, the
    serve phase's file and sharpened head): quantized weights on the card
    against the CPU's; `_int_mm` exact at the path's shapes; the f32
    reference check; one bf16 and one int8 call timed in this process
    after a warm-up each (launches asserted on the int8 call); then
    calibration on two chunks and a static-scale call."""
    import torch
    from reverb_tpu_torch.cli.reverb import ReverbASR
    from reverb_tpu_torch.decode import api
    from reverb_tpu_torch.models.asr_model import (build_model,
                                                   quantize_model_int8)
    from reverb_tpu_torch.ops import quant
    smi = smi_line()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qmodel = quantize_model_int8(asr.model)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    card = qmodel.state_dict()
    cpu = quant.quantize_params_int8({k: v.detach().cpu() for k, v in
                                      asr.model.state_dict().items()})
    if set(card) != set(cpu):
        raise AssertionError('int8: the card and the CPU quantize different '
                             'keys')
    sites = [k for k in cpu if k.endswith('.weight_q8')]
    for k in cpu:
        if k.endswith(('.weight_q8', '.w_scale')) and not torch.equal(
                card[k].cpu(), cpu[k]):
            raise AssertionError(f'int8: {k} differs between the card and '
                                 f'the CPU')
    q_bytes = sum(card[k].numel() for k in sites)
    del cpu
    log(f'int8: quantize_model_int8 {quantize_s:.3f} s on the card; '
        f'{len(sites)} int8 sites ({q_bytes / 1e6:.1f}M int8 weights), '
        f'weight_q8 and w_scale bit-equal to the CPU\'s; on {smi}')
    mm = check_int_mm(dev, qmodel, feats)
    qasr = ReverbASR.from_model(asr.configs, qmodel, asr.tokenizer)
    ref = int8_reference_check(qasr, feats, dev)

    walls, peaks, results = {}, {}, {}
    ln_calls, hooks = ln_call_counter(qmodel)
    try:
        for name, a in (('bf16', asr), ('int8', qasr)):
            transcribe_s(a, wav, MODES)                 # warm-up
            zero_launch_counts()
            ln_calls[0] = 0
            walls[name], outs, results[name], peaks[name] = served_call(a,
                                                                        wav)
            if name == 'int8':
                launches = launch_counts()
                k5_calls = ln_calls[0]
            for mode, ctm in zip(MODES, outs):
                if not check_ctm_rows(ctm, wav.name,
                                      f'int8 phase {name} {mode}'):
                    raise AssertionError(f'int8 phase {name} {mode}: empty '
                                         f'CTM')
    finally:
        for h in hooks:
            h.remove()
    n_enc = len(results['int8'])
    layers = qmodel.cfg.encoder.num_blocks
    want = {'K1': layers * n_enc, 'K2': n_enc, 'K3': n_enc, 'K5': k5_calls}
    log(f'int8 serving call launches {launches}, expected {want} ({n_enc} '
        f'encoder call(s); K5 = LayerNorm calls on the path)')
    if launches != want or k5_calls < LN_ENC * n_enc:
        raise AssertionError('the int8 serving path did not run every '
                             'kernel the expected number of times')
    same, total = matched_tokens(hyp_tokens(results['int8']),
                                 hyp_tokens(results['bf16']))
    log(f'int8 vs bf16 serving, second call of each in this process: wall '
        f'{walls["int8"]:.4f} s vs {walls["bf16"]:.4f} s (xRT '
        f'{audio_s / walls["int8"]:.1f} vs {audio_s / walls["bf16"]:.1f}), '
        f'peak {peaks["int8"] / 2**30:.2f} vs {peaks["bf16"] / 2**30:.2f} '
        f'GiB; {same} of the bf16 call\'s {total} tokens shared in order; '
        f'on {smi}')

    # static activation scales: calibrate a copy on two chunks
    smodel = build_model(qmodel.cfg, dev, state_dict=qmodel.state_dict())
    cat = torch.tensor([1.0, 0.0], device=dev)
    lens = torch.tensor([CHUNK], device=dev)
    batches = [(feats[None, i * CHUNK:(i + 1) * CHUNK],) for i in range(2)]

    def run_fn(model, x):
        api.decode(model, MODES, x, lens, beam_size=10, ctc_weight=0.1,
                   cat_embs=cat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scales = quant.calibrate_activation_scales(smodel, run_fn, batches)
    calib_s = time.perf_counter() - t0
    quant.apply_activation_scales(smodel, scales)
    sasr = ReverbASR.from_model(asr.configs, smodel, asr.tokenizer)
    transcribe_s(sasr, wav, MODES)                       # warm-up
    zero_launch_counts()
    walls['int8_static'], outs, results['static'], peaks['int8_static'] = \
        served_call(sasr, wav)
    static_launches = launch_counts()
    for mode, ctm in zip(MODES, outs):
        if not check_ctm_rows(ctm, wav.name, f'int8 static {mode}'):
            raise AssertionError(f'int8 static {mode}: empty CTM')
    s_same, s_total = matched_tokens(hyp_tokens(results['static']),
                                     hyp_tokens(results['int8']))
    log(f'int8 static scales: {len(scales)} of {len(sites)} sites calibrated '
        f'on 2 chunks in {calib_s:.2f} s; a static-scale call '
        f'{walls["int8_static"]:.4f} s (dynamic {walls["int8"]:.4f} s), '
        f'peak {peaks["int8_static"] / 2**30:.2f} GiB, launches '
        f'{static_launches}; {s_same} of the dynamic call\'s {s_total} '
        f'tokens shared in order; on {smi}')
    del smodel, sasr, qasr, qmodel
    gc.collect()
    torch.cuda.empty_cache()
    return {'launches': launches, 'calls': 1, 'walls': walls,
            'peaks': peaks, 'ref': ref, 'mm': mm, 'quantize_s': quantize_s,
            'sites': len(sites), 'calibrated': len(scales),
            'calib_s': calib_s, 'tokens_vs_bf16': (same, total),
            'static_tokens_vs_dynamic': (s_same, s_total)}


# ------------------------------ phase 18: export ------------------------------

EXPORT_TOL = 1e-4            # the f32 port tests' bar
EXPORT_CHUNKS = 4
_KERNEL_DIR_PROBE = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from reverb_tpu_torch import _build
from reverb_tpu_torch.ops import layer_norm as ln
x = torch.randn(8, 1024, device='cuda')
ln.layer_norm(x, torch.ones(1024, device='cuda'),
              torch.zeros(1024, device='cuda'))
torch.cuda.synchronize()
print(json.dumps({'build_seconds': _build.build_seconds,
                  'kernel_dir': str(_build.kernel_dir()),
                  'k5': ln.LAUNCHES}))
'''


def _max_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want) if w is not None)


def run_export(dev, asr, wav, feats, audio_s, workdir: Path):
    """`python -m reverb_tpu_torch.bin.export` on reverb_large in f32 (the
    serving weights): `--format pt2` into a directory under _chipwork/,
    each program loaded back and held to the eager module on the same
    inputs (the encoder chunk over EXPORT_CHUNKS chained windows of the
    file with the caches carried) within EXPORT_TOL, K5 counted inside
    the loaded programs; `recognize_wav --quantize int8` on the same
    checkpoint (launches asserted); then `--format aot` into a fresh
    directory, and a process started with REVERB_KERNEL_DIR set to it
    loads the library without building.  The directory is removed at the
    end."""
    import os
    import shutil
    import torch
    from reverb_tpu_torch import _build
    from reverb_tpu_torch.bin import export as export_bin
    from reverb_tpu_torch.cli import recognize_wav
    from reverb_tpu_torch.export import aot
    from reverb_tpu_torch.models.asr_model import build_model
    from reverb_tpu_torch.ops import layer_norm as ln
    from reverb_tpu_torch.utils.config import save_config
    smi = smi_line()
    base = ROOT / '_chipwork'
    base.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix='export_', dir=base))
    try:
        f32 = build_model(asr.model.cfg.with_compute_dtype(torch.float32),
                          dev, state_dict=asr.model.state_dict())
        conf, ckpt = tmp / 'config.json', tmp / 'model.pt'
        save_config(asr.configs, conf)
        torch.save({k: v.detach().cpu() for k, v in
                    f32.state_dict().items()}, ckpt)
        args = ['--config', str(conf), '--checkpoint', str(ckpt)]
        t0 = time.perf_counter()
        export_bin.main(args + ['--output_dir', str(tmp / 'pt2')])
        export_s = time.perf_counter() - t0
        sizes = {p.name: p.stat().st_size for p in (tmp / 'pt2').iterdir()}
        manifest = json.loads((tmp / 'pt2' / 'manifest.json').read_text())
        t0 = time.perf_counter()
        progs = {n: aot.load_serialized(str(tmp / 'pt2' / f'{n}.pt2'))
                 for n in aot.NAMES}
        load_s = time.perf_counter() - t0
        eager, info = aot.serving_inputs(f32)
        if (info['window'], info['cache_t']) != (manifest['window'],
                                                 manifest['cache_t']):
            raise AssertionError('export: manifest shapes')
        cat = torch.tensor([1.0, 0.0], device=dev)
        att_p = att_e = info['att_cache']
        errs, k5, k5_total = {'encoder_chunk': 0.0}, {}, 0
        stride = manifest['subsampling_rate'] * manifest['chunk_size']
        with torch.inference_mode():
            for i in range(EXPORT_CHUNKS):
                x = feats[None, i * stride:i * stride + info['window']].float()
                off = torch.tensor(i * manifest['chunk_size'],
                                   dtype=torch.int32, device=dev)
                ln.LAUNCHES = 0
                got = progs['encoder_chunk'](x, off, att_p, None, cat)
                k5['encoder_chunk'] = ln.LAUNCHES
                k5_total += ln.LAUNCHES
                want = eager['encoder_chunk'][0](x, off, att_e, None, cat)
                errs['encoder_chunk'] = max(errs['encoder_chunk'],
                                            _max_err(got, want))
                att_p, att_e = got[1], want[1]
                if not torch.isfinite(got[0]).all():
                    raise AssertionError('export: non-finite chunk output')
            ln.LAUNCHES = 0
            got = progs['ctc_activation'](got[0])
            k5['ctc_activation'] = ln.LAUNCHES
            k5_total += ln.LAUNCHES
            errs['ctc_activation'] = _max_err(
                (got,), (eager['ctc_activation'][0](want[0]),))
            g = torch.Generator(device=dev).manual_seed(SEED)
            cfg = f32.cfg
            hyps = torch.randint(1, cfg.vocab_size - 1, (10, 64), generator=g,
                                 device=dev, dtype=torch.int32)
            hyps[:, 0] = cfg.sos
            hl = torch.randint(2, 65, (10,), generator=g, device=dev,
                               dtype=torch.int32)
            enc = torch.randn(1, info['cache_t'], cfg.encoder.output_size,
                              generator=g, device=dev)
            ln.LAUNCHES = 0
            got = progs['attention_decoder'](hyps, hl, enc)
            k5['attention_decoder'] = ln.LAUNCHES
            k5_total += ln.LAUNCHES
            errs['attention_decoder'] = _max_err(
                got, eager['attention_decoder'][0](hyps, hl, enc))
            times = {}
            for n, args_ in (('encoder_chunk', (x, off, att_p, None, cat)),
                             ('attention_decoder', (hyps, hl, enc))):
                times[n] = (cuda_time_ms(lambda: progs[n](*args_), 5),
                            cuda_time_ms(lambda: eager[n][0](*args_), 5))
        want_k5 = {'encoder_chunk': LN_ENC, 'ctc_activation': 0,
                   'attention_decoder': LN_DEC}
        log(f'export: bin.export --format pt2 {export_s:.1f} s, files '
            + ', '.join(f'{n} {b / 1e6:.1f} MB' for n, b in sorted(
                sizes.items()))
            + f'; loaded in {load_s:.1f} s; loaded vs eager max abs err '
            f'{errs} (bar {EXPORT_TOL}); K5 launches inside the loaded '
            f'programs {k5} (expected {want_k5}); ms a call loaded vs eager '
            + ', '.join(f'{n} {a:.2f} vs {b:.2f}' for n, (a, b) in
                        times.items()) + f'; on {smi}')
        if any(not e <= EXPORT_TOL for e in errs.values()):
            raise AssertionError('export: a loaded program differs from the '
                                 'eager module')
        if k5 != want_k5:
            raise AssertionError('export: K5 did not run inside the loaded '
                                 'programs as expected')
        del progs
        t0 = time.perf_counter()
        if not aot.scriptability_check(f32):
            raise AssertionError('export: scriptability_check')
        log(f'export: scriptability_check (encode_and_ctc at (1, 67), K1 as '
            f'its operator) {time.perf_counter() - t0:.1f} s')
        # the console entry with --quantize int8 on the same checkpoint
        zero_launch_counts()
        t0 = time.perf_counter()
        recognize_wav.main(['--audio_file', str(wav), '--config', str(conf),
                            '--checkpoint', str(ckpt), '--modes', *MODES,
                            '--quantize', 'int8', '--compute_dtype',
                            'bfloat16', '--result_dir', str(tmp / 'rec')])
        cli_s = time.perf_counter() - t0
        cli_launches = launch_counts()
        rows = {m: check_ctm_rows((tmp / 'rec' / m / f'{wav.stem}.ctm')
                                  .read_text(), wav.name, f'int8 CLI {m}')
                for m in MODES}
        want_cli = {'K1': LAYERS_ENC, 'K2': 1, 'K3': 1}
        log(f'int8 CLI: recognize_wav --quantize int8 --compute_dtype '
            f'bfloat16 {cli_s:.1f} s with the load; CTM rows {rows}; '
            f'launches {cli_launches} (expected {want_cli} and K5 > 0); on '
            f'{smi}')
        if not all(rows.values()) or {k: cli_launches[k] for k in want_cli} \
                != want_cli or not cli_launches['K5']:
            raise AssertionError('the int8 CLI did not decode through the '
                                 'kernels')
        t0 = time.perf_counter()
        export_bin.main(args + ['--output_dir', str(tmp / 'aot'), '--format',
                                'aot'])
        aot_s = time.perf_counter() - t0
        res = subprocess.run(
            [sys.executable, '-c', _KERNEL_DIR_PROBE, str(ROOT)],
            capture_output=True, text=True, timeout=300, cwd=str(tmp),
            env={**os.environ, _build.KERNEL_DIR_ENV: str(tmp / 'aot')})
        if res.returncode != 0:
            raise AssertionError(f'export: the kernel-dir probe failed:\n'
                                 f'{res.stderr[-2000:]}')
        probe = json.loads(res.stdout.strip().splitlines()[-1])
        log(f'export: bin.export --format aot {aot_s:.1f} s (build into a '
            f'fresh directory and one run of each subgraph); a process with '
            f'REVERB_KERNEL_DIR set to it: {probe}; on {smi}')
        if probe['build_seconds'] is not None or probe['k5'] != 1 or \
                Path(probe['kernel_dir']) != tmp / 'aot':
            raise AssertionError('export: the primed kernel directory was '
                                 'not loaded as built')
        del f32, eager
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        # the exported programs and the CLI's models sit in reference
        # cycles: collect them now, not in a later phase's peak
        gc.collect()
        torch.cuda.empty_cache()
    return {'export_s': export_s, 'load_s': load_s, 'sizes': sizes,
            'errs': errs, 'k5': k5, 'k5_total': k5_total, 'times': times,
            'aot_s': aot_s, 'cli_launches': cli_launches}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--phases', default=','.join(ALL_PHASES),
                    help='comma list of kernels, serve, train, modes, '
                         'stream, diar, recipe, context, tools, remat, '
                         'diartrain, int8, export (default all; the result '
                         'lines need all thirteen), or beam: the K2/K3 and '
                         'K2b checks alone')
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
    if set(beamk) != {'beam_scan_kernel<0>', 'beam_scan_kernel<1>',
                      'beam_backtrace_kernel<0>',
                      'beam_backtrace_kernel<1>'}:
        raise AssertionError(f'the beam kernels of the build: {set(beamk)}')
    if args.ab_parent is not None:
        ab_parent(dev, args.ab_parent)
    if 'beam' in phases and 'kernels' not in phases:
        check_beam(dev, SEED)       # a quick first check of K2/K3 alone
        check_beam_biased(dev, SEED)
    if 'kernels' in phases:
        # phases 3-4, 6-7: kernels against their plain versions
        k1 = check_k1(dev)
        sdpa = sdpa_yardstick(dev)
        fwd_err, bt = check_beam(dev, SEED)
        k4 = check_k1_mask_k4(dev)[torch.bfloat16]
        lnr = check_ln(dev)[torch.bfloat16]
    if phases & {'serve', 'modes', 'stream', 'context', 'tools', 'int8',
                  'export'}:
        with tempfile.TemporaryDirectory(prefix='reverb_smoke_') as tmp:
            served = serving_setup(dev, SEED, Path(tmp))
            if 'serve' in phases:
                # phase 5: the serving path
                launches, walls, audio_s, fallback = run_slice(dev, *served)
            if 'modes' in phases:
                # phase 9: the six CLI modes
                modes = run_modes(dev, *served)
            if 'stream' in phases:
                # phase 10: streaming
                stream = run_stream(dev, *served)
            if 'context' in phases:
                # phase 13: context biasing (K2b; serving and training)
                context = run_context(dev, *served)
            if 'tools' in phases:
                # phase 14: alignment, transcribe, the app
                tools = run_tools(dev, *served, Path(tmp))
            if 'int8' in phases:
                # phase 17: --quantize int8 serving (and static scales)
                int8 = run_int8(dev, *served)
            if 'export' in phases:
                # phase 18: bin.export (pt2 programs, the aot kernel dir)
                export = run_export(dev, *served, Path(tmp))
            del served
    if 'train' in phases:
        # phase 8: the training path
        train_reference_check(dev, SEED)
        t_launch, step_ms, peak = run_train(dev, SEED)
        if args.profile:
            profile_train(dev, SEED)
    if 'diar' in phases:
        # phase 11: diarization, both routes
        diar = run_diar(dev, SEED)
    if 'recipe' in phases:
        # phase 12: the dataset path (train, recognize, get_loss, average)
        recipe = run_recipe(dev, SEED)
    if 'remat' in phases:
        # phase 15: gradient checkpointing, the new training options,
        # device_feats through bin.train
        remat = run_remat(dev, SEED)
    if 'diartrain' in phases:
        # phase 16: diarization training (K6 on the TDNN)
        diartrain = run_diartrain(dev, SEED)
    spilled = [n for n, r in {**tc, **lnk, **beamk}.items() if r[1] or r[2]]
    if spilled:
        raise AssertionError(f'kernels spill registers: {spilled}')
    if phases != set(ALL_PHASES):
        log(f'phases {sorted(phases)} passed; no result lines without all '
            f'of {ALL_PHASES}')
        return 1

    kernels = kernel_records(k1, sdpa, fwd_err, bt, k4, lnr, launches,
                             len(walls), t_launch, fallback, modes, stream,
                             diar, recipe, context, tools, remat, diartrain,
                             int8, export)
    log(f'slice: second transcribe_modes call {walls[1]:.4f} s for '
        f'{audio_s:.2f} s of audio, xRT {audio_s / walls[1]:.2f}; six-mode '
        f'call {modes[2]:.3f} s; train {step_ms:.1f} ms/step at '
        f'B={TRAIN_B}, peak {peak / 2**30:.2f} GiB; stream '
        f'{stream["single"]["p50"]:.2f} ms per hop (p50), pool '
        f'{stream["pool"]["ms"]:.2f} ms per step; diarization xRT '
        f'{diar["native"]["xrt"]:.1f} (native), '
        f'{diar["pyannote"]["xrt"]:.1f} (pyannote) on '
        f'{diar["audio_s"]:.0f} s; recipe {recipe["train"]["step_ms"]:.1f} '
        f'ms/step through bin.train ({recipe["train"]["wait_ms"]:.2f} ms '
        f'dataset wait), recognize {recipe["recognize_s"]:.1f} s; biased '
        f'serving {context["serving"]["walls"][1]:.4f} s '
        f'({context["serving"]["wall_tail"]:.4f} s with the uncapped tail), '
        f'adaptor '
        f'{context["adaptor"]["step_ms"]:.1f} ms/step; force_align '
        f'{tools["force_align_ms"]:.2f} ms at T={tools["force_align_T"]}; '
        f'checkpointed steps at B={REMAT_B}: '
        + ', '.join(f'{n} {remat["steps"][f"{n}_b{REMAT_B}"]["ms"]:.1f} ms '
                    f'{remat["steps"][f"{n}_b{REMAT_B}"]["peak_gib"]:.2f} GiB'
                    for n, _ in REMAT_RUNS)
        + f'; at B={REMAT_BIG_B}: '
        + ', '.join(f'{n} {remat["steps"][f"{n}_b{REMAT_BIG_B}"]["ms"]:.1f} '
                    f'ms {remat["steps"][f"{n}_b{REMAT_BIG_B}"]["peak_gib"]:.2f}'
                    f' GiB' for n, _ in REMAT_RUNS)
        + f'; bin.train with device_feats '
        f'{remat["device_feats"]["step_ms"]:.1f} ms/step '
        f'({remat["device_feats"]["wait_ms"]:.2f} ms wait, '
        f'{remat["device_feats"]["audio_s_per_s"]:.1f} audio-s/s) beside '
        f'host fbank {recipe["train"]["step_ms"]:.1f} ms/step '
        f'({recipe["train"]["wait_ms"]:.2f} ms wait, '
        f'{recipe["train"]["audio_s_per_s"]:.1f} audio-s/s); diarization '
        f'training {diartrain["embedding"]["ms"]:.2f} ms an embedding step, '
        f'{diartrain["segmentation"]["ms"]:.2f} ms a segmentation step, '
        f'{diartrain["clusters_trained"]} clusters trained vs '
        f'{diartrain["clusters_random"]} random; int8 serving '
        f'{int8["walls"]["int8"]:.4f} s (bf16 {int8["walls"]["bf16"]:.4f} s, '
        f'static scales {int8["walls"]["int8_static"]:.4f} s), peak '
        f'{int8["peaks"]["int8"] / 2**30:.2f} GiB (bf16 '
        f'{int8["peaks"]["bf16"] / 2**30:.2f}); export {export["export_s"]:.1f}'
        f' s, aot {export["aot_s"]:.1f} s; on {smi}')
    print(smi_line())
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def kernel_records(k1, sdpa, fwd_err, bt, k4, lnr, launches, n_calls,
                   t_launch, fallback, modes, stream, diar, recipe, context,
                   tools, remat, diartrain, int8, export):
    """The {"kernels": [...]} entries: launches on the paths (in all, per
    serving call, per training step, per six-mode call, per streaming hop,
    per pool step, per diarization call of either route, and on the
    dataset path: per bin.train step (CV included), per dynamic-chunk
    step, per get_loss utterance and per recognize batch; K2/K3 also per
    call of the long-hypothesis path; per biased serving call, with and
    without the uncapped tail, and per deep-biasing training step; per
    aligned WAV, per transcribe call and per app POST of the tools),
    the error against the plain version, kernel / plain / library times in
    bf16 at the timed shapes (K2 also resumed from a state at B = 1 and 8,
    T_hop = 16), and the bound computed from those shapes."""
    import torch
    k1b = k1[torch.bfloat16]
    N, C = LN_ROWS[-1], LN_C
    m_launch = modes[0]
    s_launch, p_launch = (stream['single']['launches'],
                          stream['pool']['launches'])
    d_launch = diar['native']['launches']
    r_train = recipe['train']['launches']
    r_dyn = recipe['dynamic_chunk']['launches']
    r_loss = recipe['get_loss_launches']
    r_rec = recipe['recognize_launches']
    r_all = {n: (r_train.get(n, 0) + r_dyn.get(n, 0) + r_loss.get(n, 0)
                 + r_rec.get(n, 0)) for n in ('K1', 'K2', 'K3', 'K4', 'K5',
                                              'K6')}
    per = {n: {'serve': launches.get(n, 0) / n_calls,
               'train': t_launch.get(n, 0) / TRAIN_STEPS,
               'six_modes': m_launch.get(n, 0),
               'stream_hop': s_launch.get(n, 0) / stream['single']['hops'],
               'stream_pool_step': (p_launch.get(n, 0)
                                    / stream['pool']['steps']),
               'diarization': d_launch[n],
               'diarization_pyannote': diar['pyannote']['launches'][n],
               'recipe_train_step': (r_train.get(n, 0)
                                     / recipe['train']['steps']),
               'recipe_dynamic_chunk_step': r_dyn.get(n, 0),
               'recipe_get_loss_utterance': r_loss.get(n, 0) / RECIPE_CV,
               'recipe_recognize_batch': (r_rec.get(n, 0)
                                          / recipe['recognize_batches'])}
           for n in ('K1', 'K2', 'K3', 'K4', 'K5', 'K6')}
    resume = {}
    for b, t in stream['resume'].items():
        resume.update({f'resume_{k}_b{b}_t16': v for k, v in t.items()})
    for n in ('K2', 'K3'):      # the uncapped tail launches them again
        per[n]['serve_long_hyp'] = fallback[0][n] / fallback[1]
    sdpa_call = ('F.scaled_dot_product_attention(cat(q+u, q+v), cat(k, p), '
                 'v, scale=1/sqrt(dk)), every row at full length')
    # the context phase: biased serving and the adaptor's training steps
    c_serve = context['serving']['launches']
    c_tail = context['serving']['launches_tail']
    c_train = context['adaptor']['launches']
    t_runs = tools['launches']       # {run: (launches, encoder calls)}
    t_per = {'alignment': TOOLS_WAVS}
    for n in ('K1', 'K2', 'K3', 'K4', 'K5', 'K6'):
        per[n]['context_serve'] = c_serve.get(n, 0) / context['serving'][
            'calls']
        per[n]['context_serve_long_hyp'] = c_tail.get(n, 0)
        per[n]['context_adaptor_train_step'] = (c_train.get(n, 0)
                                                / context['adaptor']['steps'])
        for run, (got, _) in t_runs.items():
            key = 'tools_alignment_wav' if run == 'alignment' else \
                f'tools_{run}'
            per[n][key] = got.get(n, 0) / t_per.get(run, 1)
    # phases remat and diartrain: launches a step of each run
    r_steps = remat['steps']
    r_df = remat['device_feats']
    r_ref = remat['reference']['launches']
    for n in ('K1', 'K2', 'K3', 'K4', 'K5', 'K6'):
        for run, r in r_steps.items():
            per[n][f'remat_{run}_step'] = r['launches'].get(n, 0)
        for run, got in r_ref.items():
            per[n][f'remat_f32_{run.replace(" ", "_")}_step'] = got.get(n, 0)
        per[n]['remat_device_feats_bin_train_step'] = (
            r_df['launches'].get(n, 0) / r_df['steps'])
        for part in ('embedding', 'segmentation'):
            per[n][f'diartrain_{part}_step'] = diartrain[part][
                'launches'].get(n, 0)
    # phases int8 and export: an int8 serving call; a call of each loaded
    # program
    for n in ('K1', 'K2', 'K3', 'K4', 'K5', 'K6'):
        per[n]['int8_serve'] = int8['launches'].get(n, 0) / int8['calls']
        for prog in ('encoder_chunk', 'ctc_activation', 'attention_decoder'):
            per[n][f'export_{prog}'] = export['k5'][prog] if n == 'K5' else 0
    other = {n: (int8['launches'].get(n, 0)
                 + (export['k5_total'] if n == 'K5' else 0)
                 + c_serve.get(n, 0) + c_tail.get(n, 0) + c_train.get(n, 0)
                 + sum(got.get(n, 0) for got, _ in t_runs.values())
                 + sum(r['launches'].get(n, 0) * REMAT_STEPS
                       for r in r_steps.values())
                 + sum(got.get(n, 0) for got in r_ref.values())
                 + r_df['launches'].get(n, 0)
                 + sum(round(diartrain[p]['launches'].get(n, 0)
                             * diartrain[p]['steps'])
                       for p in ('embedding', 'segmentation')))
             for n in ('K1', 'K2', 'K3', 'K4', 'K5', 'K6', 'K2b')}
    other = {n: int(round(v)) for n, v in other.items()}

    def rec(name, src, replaces, kid, err, ms, dev_ms, plain_ms, bnd,
            lib_ms, lib_dev_ms, lib_call, **extra):
        return {'name': name, 'route': 'cuda',
                'source': f'reverb_tpu_torch/csrc/{src}',
                'replaces': f'reverb_tpu/ops/{replaces}',
                'launches': (launches.get(kid, 0) + t_launch.get(kid, 0)
                             + m_launch.get(kid, 0) + s_launch.get(kid, 0)
                             + p_launch.get(kid, 0) + d_launch[kid]
                             + r_all[kid] + other[kid]),
                'launches_per_call': per[kid], 'max_abs_err': err,
                'ms': ms, 'device_ms': dev_ms, 'plain_ms': plain_ms,
                'bound_ms': bnd[0], 'bound_by': bnd[1], 'library_ms': lib_ms,
                'library_device_ms': lib_dev_ms, 'library_call': lib_call,
                **extra}
    k5d = diar['k5']
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
            us_per_frame=bt['fwd_us_frame'],
            resume_cases=stream['resume_cases'], **resume),
        # K2b: the biased scan (JAX runs it on its lax.scan path, no
        # Pallas kernel); launched by biased serving only
        {'name': 'beam_scan_forward_biased', 'route': 'cuda',
         'source': 'reverb_tpu_torch/csrc/beam_scan.cu',
         'replaces': 'reverb_tpu/decode/prefix_beam.py:82 (_step with '
                     'ctx_tables, on lax.scan; the biased variant of '
                     'reverb_tpu/ops/beam_scan.py:33)',
         'launches': other['K2b'],
         'launches_per_call': {
             'context_serve': c_serve['K2b'] / context['serving']['calls'],
             'context_serve_long_hyp': c_tail['K2b'],
             'tools_transcribe_context': t_runs['transcribe_context'][0][
                 'K2b']},
         'max_abs_err': context['k2b_err'], 'ms': context['k2b']['ms'],
         'device_ms': context['k2b']['device_ms'],
         'plain_ms': context['k2b']['plain'],
         'bound_ms': bound(0, context['k2b']['nbytes'], 'f32')[0],
         'bound_by': bound(0, context['k2b']['nbytes'], 'f32')[1],
         'library_ms': None, 'library_device_ms': None,
         'library_call': 'none',
         'us_per_frame': context['k2b']['us_frame'],
         'unbiased_k2_ms_same_call': context['k2b']['k2_ms'],
         'unbiased_k2_device_ms_same_call': context['k2b']['k2_device_ms']},
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
            'F.layer_norm(x, (C,), w, b, eps)',
            diarization_shape=k5d['shape'],
            diarization_dtype='float32',
            max_abs_err_diarization=k5d['max_abs_err'],
            ms_diarization=k5d['ms'], device_ms_diarization=k5d['device_ms'],
            plain_ms_diarization=k5d['plain_ms'],
            bound_ms_diarization=k5d['bound_ms'],
            bound_by_diarization=k5d['bound_by'],
            library_ms_diarization=k5d['library_ms'],
            library_device_ms_diarization=k5d['library_device_ms']),
        rec('layer_norm_bwd', 'layer_norm.cu', 'layer_norm.py:96', 'K6',
            max(lnr['errs'][n] for n in ('dx', 'dw', 'db')), lnr['t']['bwd'],
            lnr['t']['bwd_dev'], lnr['t']['bwd_plain'],
            bound(10 * N * C, lnr['t']['bwd_nbytes'], 'f32'),
            lnr['t']['bwd_library'], lnr['t']['bwd_library_dev'],
            'torch.autograd.grad through F.layer_norm(x, (C,), w, b, eps)'),
    ]


if __name__ == '__main__':
    sys.exit(main())
