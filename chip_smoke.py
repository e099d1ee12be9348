#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (reverb_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
reverb_tpu_torch/csrc, holds each kernel to its plain PyTorch version at
the serving shapes, then drives the serving path through the user entry
point — `ReverbASR.transcribe_modes(['ctc_prefix_beam_search',
'attention_rescoring'], format='ctm')` — on a reverb_large-width model
(18-layer LSL conformer, d=1024, 16 heads, 6+3-layer bitransformer
decoder, V=10000, bf16) with seeded random weights and a synthetic 164 s
wav (8 chunks of 2051 frames).  Every phase raises on failure; the exit
code is 0 only when all of them pass.

Output: progress lines, then the card's `nvidia-smi` name and power limit,
then one JSON line {"kernels": [...]} (each kernel's launches on the
serving path, its error against the plain version, and both times), and
last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MODES = ['ctc_prefix_beam_search', 'attention_rescoring']
CHUNK = 2051                 # frames per chunk (CLI default)
N_CHUNKS = 8                 # one full batch of the auto batcher
VOCAB = 10000
SEED = 0                     # weights, audio and beam inputs


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs, after one warm-up."""
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


# ------------------------------ phase 3: K1 ------------------------------

def check_k1(dev):
    """K1 against its plain version at B·H = 8·16, T = 512, dk = 64, ragged
    kv_lens, valid rows only.  f32: ≤ 1e-4 (summation order only).  bf16 on
    unit-scale inputs (|out| ≤ 1): ≤ 2e-2 (the output is rounded to bf16)."""
    import torch
    from reverb_tpu_torch.ops import flash_attention as fa
    B, H, T, dk = 8, 16, 512, 64
    lens = torch.tensor([512, 300, 1, 0, 512, 17, 64, 65], device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        def rnd(*shape):
            return (torch.rand(*shape, device=dev, generator=g) * 2 - 1).to(
                dtype)
        # (B, T, H, dk) projections read through strides, as in the encoder
        q, k, v = (rnd(B, T, H, dk).transpose(1, 2) for _ in range(3))
        pos = rnd(1, H, T, dk)
        u, vb = rnd(H, dk).float() * 0.1, rnd(H, dk).float() * 0.1
        args = (q, k, v, pos, u, vb, lens)
        got = fa.rel_pos_attention(*args)
        want = fa.rel_pos_attention_plain(*args)
        torch.cuda.synchronize()
        err = 0.0
        for b in range(B):
            L = int(lens[b])
            if L == 0:
                if torch.count_nonzero(got[b]):
                    raise AssertionError('K1: kv_len 0 row is not 0')
                continue
            err = max(err, float((got[b, :, :L].float()
                                  - want[b, :, :L].float()).abs().max()))
        if not err <= tol:
            raise AssertionError(f'K1 {dtype}: max abs err {err} > {tol}')
        # timed as the encoder calls it: every row at the full T
        full = (q, k, v, pos, u, vb, torch.full_like(lens, T))
        ms = cuda_time_ms(lambda: fa.rel_pos_attention(*full), 20)
        plain_ms = cuda_time_ms(lambda: fa.rel_pos_attention_plain(*full), 20)
        log(f'K1 rel_pos_attention {dtype}: max_abs_err={err} (tol {tol}); '
            f'all rows at T={T}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms')
        out[dtype] = (err, ms, plain_ms)
    return out[torch.bfloat16]          # the serving dtype


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


def check_beam(dev, seed):
    """K2+K3 against the plain beam at B=8, T=512, K=K2=10, dense and with
    blank-skip 0.95: prefixes, plens and times exactly equal, scores within
    1e-4.  Times each kernel against its plain version (dense shapes)."""
    import torch
    from reverb_tpu_torch.decode import prefix_beam as pb
    from reverb_tpu_torch.ops import beam_scan as bs
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

    # timing at the dense serving shapes
    ts = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(
        B, T).contiguous()
    valid = torch.arange(T, device=dev)[None] < lens[:, None]
    acc = torch.zeros((B, T), dtype=torch.float32, device=dev)
    hs = torch.zeros((B, T), dtype=torch.bool, device=dev)
    fwd_args = (lp, ix, ts, valid, acc, hs, K, 0)
    final, em = bs.beam_scan_forward(*fwd_args)
    final_p, em_p = bs.beam_scan_forward_plain(*fwd_args)
    fwd_err = max(float((final[n] - final_p[n]).abs().max())
                  for n in ('s', 'ns', 'v_s', 'v_ns'))
    if not (fwd_err <= 1e-4 and all(torch.equal(em[n], em_p[n])
                                    for n in em)):
        raise AssertionError('K2 records differ from the plain scan')
    order = torch.argsort(-pb._log_add(final['s'], final['ns']), dim=-1,
                          stable=True).to(torch.int32)
    sel = torch.gather(~(final['v_s'] > final['v_ns']), 1, order.long())
    bt_args = (em, order, sel, 256)
    pre, tim = bs.beam_backtrace(*bt_args)
    pre_p, tim_p = bs.beam_backtrace_plain(*bt_args)
    if not (torch.equal(pre, pre_p) and torch.equal(tim, tim_p)):
        raise AssertionError('K3 output differs from the plain backtrace')
    t = {
        'fwd': cuda_time_ms(lambda: bs.beam_scan_forward(*fwd_args), 5),
        'fwd_plain': cuda_time_ms(
            lambda: bs.beam_scan_forward_plain(*fwd_args), 1),
        'bt': cuda_time_ms(lambda: bs.beam_backtrace(*bt_args), 5),
        'bt_plain': cuda_time_ms(lambda: bs.beam_backtrace_plain(*bt_args),
                                 1),
    }
    log(f'K2 beam_scan_forward: kernel {t["fwd"]:.4f} ms, plain '
        f'{t["fwd_plain"]:.4f} ms; K3 beam_backtrace: kernel '
        f'{t["bt"]:.4f} ms, plain {t["bt_plain"]:.4f} ms (B=8, T=512, K=10)')
    return fwd_err, t


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
    from reverb_tpu.text.tokenizer import init_tokenizer
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
    from reverb_tpu_torch.ops import flash_attention as fa
    model = asr.model
    f32 = build_model(model.cfg.with_compute_dtype(torch.float32), dev,
                      state_dict=model.state_dict())
    x = feats[None, :CHUNK]
    lens = torch.tensor([CHUNK], device=dev)
    cat = torch.tensor([1.0, 0.0], device=dev)
    saved = (fa.rel_pos_attention, bs.beam_scan_forward, bs.beam_backtrace)
    plain = (fa.rel_pos_attention_plain, bs.beam_scan_forward_plain,
             bs.beam_backtrace_plain)

    def run(kernels: bool, fn):
        (fa.rel_pos_attention, bs.beam_scan_forward,
         bs.beam_backtrace) = saved if kernels else plain
        try:
            with torch.inference_mode():
                return fn()
        finally:
            fa.rel_pos_attention, bs.beam_scan_forward, bs.beam_backtrace = \
                saved

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
    del f32
    torch.cuda.empty_cache()


def run_slice(dev, seed, workdir: Path):
    import torch
    from reverb_tpu_torch.cli import reverb as rv
    from reverb_tpu_torch.ops import beam_scan as bs
    from reverb_tpu_torch.ops import flash_attention as fa
    asr = build_asr(dev, seed, workdir)
    n_samples = 400 + 160 * (N_CHUNKS * CHUNK - 1)
    wav = workdir / 'long.wav'
    write_wav(wav, n_samples, seed)
    audio_s = n_samples / 16000
    feats = asr.compute_feats(str(wav))
    if tuple(feats.shape) != (N_CHUNKS * CHUNK, 80) or \
            not torch.isfinite(feats).all():
        raise AssertionError(f'fbank: shape {tuple(feats.shape)}')
    q = sharpen_ctc_head(asr, feats)
    log(f'ctc head: weight x8, blank bias +{q:.3f} (75th percentile)')
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
    fa.LAUNCHES = bs.FWD_LAUNCHES = bs.BT_LAUNCHES = 0
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
                'K3': bs.BT_LAUNCHES}
    n_enc = len(captured)              # one encoder pass per decode batch
    layers = asr.model.cfg.encoder.num_blocks
    want = {'K1': layers * n_enc, 'K2': n_enc, 'K3': n_enc}
    log(f'serving path launches {launches}, expected {want} '
        f'({n_enc} encoder calls x {layers} layers)')
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
    return launches, walls, audio_s


def main():
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
    # phases 3-4: kernels against their plain versions
    k1_err, k1_ms, k1_plain = check_k1(dev)
    fwd_err, bt = check_beam(dev, SEED)
    # phase 5: the serving path
    with tempfile.TemporaryDirectory(prefix='reverb_smoke_') as tmp:
        launches, walls, audio_s = run_slice(dev, SEED, Path(tmp))

    kernels = [
        {'name': 'rel_pos_attention_fwd', 'route': 'cuda',
         'source': 'reverb_tpu_torch/csrc/rel_pos_attention.cu',
         'replaces': 'reverb_tpu/ops/flash_attention.py:108',
         'launches': launches['K1'], 'max_abs_err': k1_err, 'ms': k1_ms,
         'plain_ms': k1_plain},
        {'name': 'beam_scan_forward', 'route': 'cuda',
         'source': 'reverb_tpu_torch/csrc/beam_scan.cu',
         'replaces': 'reverb_tpu/ops/beam_scan.py:33',
         'launches': launches['K2'], 'max_abs_err': fwd_err,
         'ms': bt['fwd'], 'plain_ms': bt['fwd_plain']},
        {'name': 'beam_backtrace', 'route': 'cuda',
         'source': 'reverb_tpu_torch/csrc/beam_scan.cu',
         'replaces': 'reverb_tpu/ops/beam_scan.py:137',
         'launches': launches['K3'], 'max_abs_err': 0.0,
         'ms': bt['bt'], 'plain_ms': bt['bt_plain']},
    ]
    log(f'slice: second transcribe_modes call {walls[1]:.4f} s for '
        f'{audio_s:.2f} s of audio, xRT {audio_s / walls[1]:.2f}, on {smi}')
    print(smi_line())
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
