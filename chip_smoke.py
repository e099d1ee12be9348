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

    python3 chip_smoke.py --phases parallel     # sharded training steps;
                                                #   data-parallel serving

    python3 chip_smoke.py --phases families     # MoE, the transducer, the
                                                #   alternative encoders

    python3 chip_smoke.py --phases paraformer   # the Paraformer family,
                                                #   the transformer encoder

    python3 chip_smoke.py --phases whisper,objectives   # Whisper; SSL,
                                                #   CTL, LF-MMI, TS, LoRA

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
  the 164 s wav after a one-chunk warm-up call — kernels K1, K5
  (encoder and every decoder step), K2 and K3 (once per encoder call,
  over the dense CTC table);
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

- recipe (reverb_large's widths at RECIPE_LAYERS = 6 encoder layers):
  `bin.train.main` in-process (dither 0.1, spec_aug, shuffle and
  sort, static batch 8, 4 workers, Adam with warmuplr, clip 50) for 6
  steps with a snapshot and CV every 3 steps, then CV and `epoch_0.npz`
  (CMVN stats inside, finite cv_loss) — K1 = K4 = 6 and K5 = K6 = 60 a
  step, K1 6 and K5 60 a CV batch; ms per step, the wait on the
  dataset iterator, audio-s/s, peak memory; one step of a
  use_dynamic_chunk copy of the config (K1 = K4 = 0: the chunk mask takes
  the masked route; K5 = K6 = 60); then `bin.average_model` over the
  step-3 snapshot and epoch_0, `bin.get_loss` on the CV list (8 finite
  lines; K1 6 and K5 60 an utterance) and `bin.recognize` with the
  serving mode pair (K1 6, K2 = K3 = 1 a batch, plus one of each through
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

then parallelism (parallel/, the sharded step of train/trainer.py):

- parallel (reverb_large's widths at PAR_LAYERS = 4 encoder layers and
  a 1 + 1-layer decoder): at
  world size 1 over NCCL, the sharded step (ZeRO and TP split nothing at
  one rank) against the unwrapped step in f32 at B = 2 with dropout
  (loss and grad norm within 1e-5 relative, parameters within 1e-5 after
  an Adam step at lr 1e-3), every K1/K4/K5/K6 call held to its plain
  version and counted, and its bf16 step at B = 8 (ms, peak memory); then
  two ranks on the one card over gloo with CUDA tensors (processes of
  this script, `--parallel-child`, joined by
  parallel/mesh.py:init_distributed): DDP, ZeRO-1/2, ZeRO-3, TP 2, 'seq'
  2, 'expert' 2 (8 experts, 2 a token), 'pipe' 2 (4 microbatches,
  layer_norm conv modules), TP 2 over layer_norm, wav2vec 2.0 and
  teacher-student under DDP 2, and the registry families under the other
  axes: the SANM Paraformer (SanmConfig()'s widths) and Whisper
  (large-v3's) under TP 2, the Branchformer under 'seq' 2, a transducer
  under 'pipe' 2 and wav2vec 2.0 under DDP 2 × accum_grad 2
  (PAR_FORMS_N); then four ranks on the one card over gloo: the GPipe
  region under 'seq' and 'expert' — 'pipe' 2 × 'seq' 2 (layer_norm
  conv modules; every stage on the rank's time block), 'pipe' 2 ×
  'expert' 2 (the MoE model, the region layers' experts split inside
  each stage) and the transducer under 'pipe' 2 × 'seq' 2
  (PAR_FORMS_REGION); each an f32 step held to the
  unwrapped one of its model on loss, grad norm and every parameter —
  within 1e-3 of the whole batch at once (the forms whose data axis is 1
  with dropout, but 'pipe': the split layers draw the unwrapped masks; at
  world 1 the row split alone is measured by loss term, the floor under
  that bound) and, for the data-parallel reverb_large forms, within 1e-5
  of the batch as micro-batches of a rank's rows — rank 0's kernel calls
  held to their plain versions ('seq': K1 with Tq ≠ Tk, every step
  split), and a timed step with ms a step and peak memory per rank (the
  f32 model's next step on one card over gloo; over NCCL a bf16 step at
  B = 8, reverb_large's held to the unwrapped bf16 step, PAR_BF16_TOL),
  every step
  of every rank launching what rank 0's unwrapped step launched ('pipe':
  each stage's region layers once a microbatch; its bubble share
  reported); a form that raises in a collective reported on its own
  line, and the phase failed; the same over NCCL where there are
  two cards, and DP 2 × TP 2, 'pipe' 2 × TP 2, 'seq' 2 × TP 2 and
  PAR_FORMS_REGION over NCCL where there are four; and
  `ReverbASR(data_parallel=device_count)` on the serving file, its CTM
  byte-identical to one replica's decoding the same row blocks.

then the model families of the registry (models/registry.py), with
seeded random weights at reverb_large width:

- families: (b) the MoE conformer (`positionwise_layer_type: moe`, 8
  experts, 2 a token; 2.4B parameters): the serve phase's f32 reference
  on one chunk (K1/K5 against the plain versions, the decode tail
  identical), then a warm-up and a timed bf16 `transcribe_modes(MODES,
  format='ctm')` on the 164 s file (K1 18, K2 = K3 = 1 an encoder call,
  K5 at every LayerNorm), whose CTM K2/K3 swapped for their plain
  versions leave byte-equal; at 6 layers an f32 reference step (every
  K1/K4/K5/K6 call held to its plain version, loss and gradient against
  the plain versions' run) and a timed bf16 step at B = 8.  (a) The
  transducer (the default RNN predictor and joint, a CTC head): one f32
  chunk through the kernels (each K1/K5 call checked) and the plain
  versions with equal greedy and TSD tokens; in bf16 the encoder over the
  8 chunks (K1 18, K5 91), the batched greedy search and the device TSD
  (beam 4) over all 8, and default / alsd / nsc / maes on one chunk each,
  timed; the f32 reference step at B = 2 and 3 bf16 steps at B = 4 of
  800-1000 frames, U ≤ 32 (ms, audio-s/s, peak); `rnnt_loss` alone on
  that lattice; `bin.train` on a 2-layer transducer config with a
  checkpoint written and resumed (launches asserted).  (c) Branchformer,
  E-Branchformer, Squeezeformer and the Efficient Conformer at 6 layers
  with the hybrid loss: each an f32 reference step and a timed bf16 step
  at B = 8 (K1 = K4 = 6, 6, 0 and 2 a step: the rel-pos attention layers).

then the Paraformer family and the transformer encoder, with seeded random
weights:

- paraformer: the SANM Paraformer at SanmConfig()'s widths (LFR 7/6 →
  560 → 512, 4 heads, 2048 units, 50 + 16 blocks, V 8404, the V3 CIF
  predictor with its tp branch at upsample 3; f32; its CIF output bias set
  so that α averages 0.25 a frame) written as a model directory
  (config.yaml, 8404 units, final.pt); `cli/transcribe.main([wav, '-m',
  dir, '--paraformer', '-t'])` on a 60 s WAV, a first call with every K5
  call held to its plain version and a timed second call (the CLI's wall,
  transcribe() alone), K5 167 a call;
  the same call through the plain versions: text, tokens and times equal,
  confidences within 1e-5; a fourth call under torch.profiler, whose
  `paraformer.*` spans give the encoder, CIF loop, decoder and search
  their host ms and the device ms of the work launched inside them.  Its f32 reference step at full depth (B = 2;
  every K5/K6 call against its plain version, the gradient against f64)
  and `bin.train.main` in bf16 at B = 8 of 1600-2051 frames (K5 234 and
  K6 167 a step: the sampler's frozen decoder pass adds 67 K5); then the
  conformer-encoder Paraformer and a transformer-encoder asr_model
  (abs_pos, plain MHA) at reverb_large width and 6 layers, each an f32
  reference step and timed bf16 steps at B = 8 (K1 = K4 = 6 and 0 a
  step), and the transformer's serving call on the 60 s WAV.

then Whisper and the other training objectives, with seeded random
weights:

- whisper: `init_model` of a Whisper at openai/whisper-large-v3's widths
  (128 mels, 1500 audio frames, d 1280, 20 heads, 32 + 32 layers, V
  51866, 448 text positions; 1.55B parameters, f32); 4 WAVs of 30 s
  through the port's `compute_log_mel_spectrogram` (128 bins), then
  `whisper_greedy_decode` with the 4-token prompt and max_len 64: a call
  with every K5 call held to its plain version, a timed call (wall, the
  encoder alone, ms a position, peak; K5 65 + 97 a position, no other
  kernel), and the decode through the plain LayerNorm, whose tokens are
  equal up to the first logit gap under 1e-3; the bundle's loss in f32 at
  B = 1 with every K5/K6 call held to its plain version, then two Adam
  steps at B = 4 × 30 s, U ≤ 64 (B = 2 where B = 4 does not fit or peaks
  above 70 GiB; ms, audio-s/s, peak);
- objectives: at reverb_large width and 6 layers, BEST-RQ, wav2vec 2.0,
  w2v-BERT, CTL (20 negatives, a dynamic chunk) and the LF-MMI k2_model
  (the dense unigram denominator at V 10000, the bigram graph at V 64)
  through their registry bundles: each an f32 reference step (every
  K1/K4/K5/K6 call held to its plain version, the gradient against f64)
  and timed bf16 steps at B = 8 (K1 = K4 = 6 a step); teacher-student
  (teacher reverb_large, student at reverb_small's widths, top-8 KL):
  the reference and steps (K1 12 + 18, K4 12); LoRA (rank 8, the base
  frozen): steps (K1 = K4 = 6), then on an f32 copy `merge_lora` and a
  timed serving call of the merged model on the 164 s file (K1 6, K2 =
  K3 = 1), its CTM equal to the adapter model's; the LF-MMI denominators
  alone at B = 8, T = 512.

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
              'export', 'parallel', 'families', 'paraformer', 'whisper',
              'objectives')


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


def build_asr(dev, seed, workdir: Path, enc_overrides=None):
    """reverb_large-width ReverbASR in bf16 with seeded random weights and a
    char tokenizer over a generated 10000-entry symbol table
    (`enc_overrides`: keys over its encoder_conf)."""
    import torch
    from reverb_tpu_torch.text.tokenizer import init_tokenizer
    from reverb_tpu_torch.cli.reverb import ReverbASR
    from reverb_tpu_torch.models import presets
    from reverb_tpu_torch.models.asr_model import ModelConfig, build_model
    configs = presets.reverb_large()
    configs['encoder_conf'].update(enc_overrides or {})
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
    what = f' {enc_overrides}' if enc_overrides else ''
    log(f'model: reverb_large width{what}, {n_params / 1e6:.1f}M params, '
        f'bf16 compute, built in {time.perf_counter() - t0:.2f} s')
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


def reference_check(asr, feats, dev, ulps: int = 0):
    """One chunk in f32 (TF32 off), kernels against the plain PyTorch
    versions: the encoder output within 1e-3, then the decode tail (CTC
    top-k → beam → rescoring) on the SAME encoder output with identical
    tokens, times and choices and scores within 1e-4.  (Decoded tokens of
    two encoder runs are not compared: with random weights and a ×8 head,
    1e-6 encoder differences flip near-tied hypotheses.)  `ulps`: the
    uncapped tail's scores may also differ by that many f32 spacings
    (`compare_results`)."""
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
    n_long = compare_results(res_k, res_p, 1e-4, ulps)
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
                raise AssertionError(
                    f'{mode}: scores differ by more than {tol} or {ulps} '
                    f'f32 spacings (score {g.score!r} vs {w.score!r}, '
                    f'nbest {g.nbest_scores!r} vs {w.nbest_scores!r})')
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


def transcribe_s(asr, wav, modes, **kwargs) -> tuple:
    """(seconds, outputs) of one transcribe_modes call, synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = asr.transcribe_modes(str(wav), modes, format='ctm', **kwargs)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def run_modes(dev, asr, wav, feats, audio_s):
    """The six CLI modes at reverb_large width: the f32 reference check,
    then the bf16 `transcribe_modes` call with all six on the 8-chunk
    wav (after a one-chunk warm-up call) with its launch counts asserted.
    Returns
    (launches, encoder calls, seconds of the six-mode call)."""
    from reverb_tpu_torch.cli import reverb as rv
    from reverb_tpu_torch.ops import beam_scan as bs
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    modes_reference_check(asr, feats, dev)
    # the warm-up call on one chunk (the eight-chunk one took ~20 s)
    warm_wav = wav.with_name('warm.wav')
    write_wav(warm_wav, 400 + 160 * (CHUNK - 1), SEED + 1)
    warm, _ = transcribe_s(asr, warm_wav, CLI_MODES)
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
    log(f'modes: {audio_s:.2f} s of audio in {N_CHUNKS} chunks, bf16; '
        f'six-mode transcribe_modes {wall:.3f} s (one-chunk warm-up call '
        f'{warm:.3f} s); CTM rows {rows}; on {smi_line()}')
    return launches, n_enc, wall


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
# reverb_large's widths at 6 encoder layers (LSL first and last), for the
# all-phase run's time: its checkpoints and steps at 18 took ~3× as long;
# 5 LayerNorms a layer and after_norm
RECIPE_LAYERS = 6
RECIPE_LN_ENC = 5 * RECIPE_LAYERS + 1
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
    """presets.reverb_large() at RECIPE_LAYERS encoder layers in bf16 with
    the char tokenizer over the generated table, global CMVN, and the
    dataset_conf of the recipe (with `device_feats`, the fbank, dither and
    SpecAugment in the step)."""
    from reverb_tpu_torch.models import presets
    configs = presets.reverb_large()
    configs['encoder_conf'] = dict(configs['encoder_conf'],
                                   num_blocks=RECIPE_LAYERS)
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


def timed_bin_train(rec: dict) -> dict:
    """Module attributes to swap in around `bin.train.main`: the
    executor's epoch with its step and its dataset iterator timed (each
    step's wall, ending in the step's host read, into rec['step'] with its
    audio seconds in rec['audio']; each wait on the iterator into
    rec['wait']), and the eval steps counted into rec['eval']."""
    from reverb_tpu_torch.train import executor as exmod
    from reverb_tpu_torch.train import trainer
    orig_train, orig_eval = exmod.Executor.train, trainer.make_eval_step

    def train(self, model, optimizer, dataset, *a, **k):
        step_fn = self.train_step

        def timed_step(m, batch, g):
            t0 = time.perf_counter()
            out = step_fn(m, batch, g)           # ends in a host read
            rec['step'].append(time.perf_counter() - t0)
            rec['audio'].append(float(batch['feats_lengths'].sum()) / 100.0)
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
            return orig_train(self, model, optimizer, timed_iter(), *a, **k)
        finally:
            self.train_step = step_fn

    def make_eval_step(cfg, **kw):
        fn = orig_eval(cfg, **kw)

        def eval_step(m, batch, generator=None):
            rec['eval'] += 1
            return fn(m, batch, generator)
        return eval_step
    return {(exmod.Executor, 'train'): train,
            (trainer, 'make_eval_step'): make_eval_step}


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
    tag = '_device_feats' if device_feats else ''
    cfg_path = workdir / f'recipe{tag}.yaml'
    cfg_path.write_text(json.dumps(recipe_config(
        workdir, device_feats=device_feats)))
    model_dir = workdir / f'exp{tag}'
    rec = {'wait': [], 'step': [], 'audio': [], 'eval': 0, 'ln': [0]}

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
    with swapped({**timed_bin_train(rec),
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
    per = RECIPE_LN_ENC + LN_DEC
    want = {'K1': RECIPE_LAYERS * (steps + n_eval),
            'K4': RECIPE_LAYERS * steps,
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
    want = {'K1': 0, 'K4': 0, 'K5': RECIPE_LN_ENC + LN_DEC,
            'K6': RECIPE_LN_ENC + LN_DEC}
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
    want = {'K1': RECIPE_LAYERS * RECIPE_CV, 'K2': 0, 'K3': 0,
            'K5': (RECIPE_LN_ENC + LN_DEC) * RECIPE_CV}
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
    want = {'K1': RECIPE_LAYERS * nb, 'K2': nb + nu, 'K3': nb + nu,
            'K5': seen['ln'][0]}
    texts = {m: (workdir / 'rec' / m / 'text').read_text(
        encoding='utf8').splitlines() for m in RECIPE_MODES}
    log(f'recipe recognize: {nb} batches ({nu} through the uncapped tail) '
        f'in {res["recognize_s"]:.1f} s; launches {launches}, expected '
        f'{want}; rows {[len(t) for t in texts.values()]}; first '
        f'{texts[RECIPE_MODES[-1]][0][:80]!r}')
    if nb != 1 or launches != want or seen['ln'][0] < RECIPE_LN_ENC * nb or \
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


def checked_kernels(errs, shapes=None):
    """K1, K4, K5 and K6 as module attributes to swap in: each call runs
    the kernel, then its plain version on the call's own inputs (K4 and K6
    with the call's own upstream gradient), and keeps each output's worst
    error relative to the output's largest value in errs.  K1's output is
    compared on valid query rows only (a padded row is read by no one).
    With `shapes` (a set) each K1 call adds its (Tq, Tk)."""
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
        if shapes is not None:
            shapes.add((q.shape[2], k.shape[2]))
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


def check_call_errs(errs, what: str, kernels=tuple(RECIPE_CALL_TOL)):
    """Raise unless every kernel output in errs is within RECIPE_CALL_TOL
    and exactly `kernels` (by default K1, K4, K5 and K6) were seen."""
    bad = {n: e for n, e in errs.items()
           if not e <= RECIPE_CALL_TOL[n.split()[0]]}
    seen = {n.split()[0] for n in errs}
    if bad or seen != set(kernels):
        raise AssertionError(f'{what}: kernel calls against their plain '
                             f'versions {errs} (tolerances '
                             f'{RECIPE_CALL_TOL}; kernels seen {seen}, '
                             f'expected {set(kernels)})')


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
    nbest identical, scores within 1e-4 or four f32 steps."""
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
    # the rescoring score sums ~450 decoder log-probs near -2750 (one f32
    # spacing 2.4e-4), every LayerNorm K5 in one run and plain in the
    # other: 4 spacings, 3.6e-7 of the score (one run differed by 2)
    compare_results(got, want, 1e-4, ulps=4)
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


def train_model(dev, seed, dtype, overrides=None):
    """reverb_large from a generator of `seed` in `dtype`, its optimizer
    and its step; `overrides` replace keys of the preset's config."""
    import torch
    from reverb_tpu_torch.models import presets
    from reverb_tpu_torch.models.asr_model import ModelConfig, build_model
    from reverb_tpu_torch.train.trainer import (TrainConfig,
                                                build_optimizer,
                                                make_train_step)
    configs = {**presets.reverb_large(), **(overrides or {})}
    cfg = ModelConfig.from_config(configs).with_compute_dtype(dtype)
    model = build_model(cfg, dev, generator=torch.Generator(
        device=dev).manual_seed(seed), train=True)
    tc = TrainConfig.from_config(configs)
    opt, _ = build_optimizer(tc, model)
    return model, opt, make_train_step(cfg, opt, tc.accum_grad, tc.grad_clip)


def loss_and_grads(model, batch, dev, table=None, loss_fn=None):
    """(loss, [gradient of each parameter]) of compute_loss (or a
    registry bundle's `loss_fn`) + backward on `batch`, with the module
    attributes of `table` swapped in and dropout from a generator of seed
    7 (two calls draw the same masks)."""
    import torch
    from reverb_tpu_torch.models.asr_model import compute_loss
    with swapped(table or {}):
        for p in model.parameters():
            p.grad = None
        out = (loss_fn or compute_loss)(
            model, batch, torch.Generator(device=dev).manual_seed(7))
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


# ------------------------------ phase 19: parallelism ------------------------------

# reverb_large's widths at PAR_LAYERS encoder layers (LSL first and last
# around two middle ones) and PAR_DEC decoder layers (one left, one
# right), for every form (the all-phase run's time)
PAR_LAYERS = 4
PAR_DEC = {'num_blocks': 1, 'r_num_blocks': 1}
PAR_LN_DEC = 3 * 2 + 2       # 3 LayerNorms a decoder layer, 2 after_norms
# (name, mesh axes, Sharding options, model kind): the forms of two ranks
# (gloo on one card; NCCL on two cards) and of four (NCCL on four cards).
# Kinds (`par_configs`): 'base' reverb_large; 'moe' with the MoE
# feed-forward, 8 experts, 2 a token; 'ln' with layer_norm conv modules and
# a GPipe config of 2 stages in 4 microbatches (in order without a 'pipe'
# axis); 'wav2vec2' the SSL family (its global code perplexity); 'ts' a
# reverb_small-width student of a reverb_large teacher; the registry
# families 'paraformer' (the SANM Paraformer at SanmConfig()'s widths,
# PARA_LAYERS encoder and decoder blocks), 'whisper' (large-v3's widths,
# 4 + 4 blocks), 'branchformer' (reverb_large's widths) and 'transducer'
# (over the 'ln' conformer).  An `accum_grad` option is the step's, not
# the Sharding's.  At one rank ZeRO and TP split nothing, so world 1 runs
# the sharded step once
PAR_FORMS_N = {2: (('ddp', {'data': 2}, {'zero': False}, 'base'),
                   ('zero12', {'data': 2}, {'zero': True}, 'base'),
                   ('zero3', {'data': 2}, {'zero3': True}, 'base'),
                   ('tp2', {'model': 2}, {'zero': True}, 'base'),
                   ('seq2', {'seq': 2}, {'zero': True}, 'base'),
                   ('expert2', {'expert': 2}, {'zero': True}, 'moe'),
                   ('pipe2', {'pipe': 2}, {'zero': True}, 'ln'),
                   ('tp2_ln', {'model': 2}, {'zero': True}, 'ln'),
                   ('ddp2_wav2vec2', {'data': 2}, {'zero': False},
                    'wav2vec2'),
                   ('ddp2_ts', {'data': 2}, {'zero': False}, 'ts'),
                   ('tp2_paraformer', {'model': 2}, {'zero': True},
                    'paraformer'),
                   ('tp2_whisper', {'model': 2}, {'zero': True}, 'whisper'),
                   ('seq2_branchformer', {'seq': 2}, {'zero': True},
                    'branchformer'),
                   ('pipe2_transducer', {'pipe': 2}, {'zero': True},
                    'transducer'),
                   ('ddp2_accum2_wav2vec2', {'data': 2},
                    {'zero': False, 'accum_grad': 2}, 'wav2vec2')),
               4: (('dp2tp2', {'data': 2, 'model': 2}, {'zero': True},
                    'base'),
                   ('pipe2tp2', {'pipe': 2, 'model': 2}, {'zero': True},
                    'ln'),
                   ('seq2tp2', {'seq': 2, 'model': 2}, {'zero': True},
                    'base'))}
# 'seq' and 'expert' inside the GPipe region: each stage on the rank's time
# block, the region layers' experts split inside each stage (four ranks:
# over gloo on one card as well as over NCCL on four)
PAR_FORMS_REGION = (('pipe2seq2', {'pipe': 2, 'seq': 2}, {'zero': True},
                     'ln'),
                    ('pipe2expert2', {'pipe': 2, 'expert': 2},
                     {'zero': True}, 'moe'),
                    ('pipe2seq2_transducer', {'pipe': 2, 'seq': 2},
                     {'zero': True}, 'transducer'))
PAR_FORMS_N[4] += PAR_FORMS_REGION


def par_forms(backend: str, world: int) -> tuple:
    """The forms of a run of `world` ranks over `backend`: four ranks on
    one card over gloo run PAR_FORMS_REGION alone (the other four-rank
    forms need no more than what their two-rank forms check there)."""
    return (PAR_FORMS_REGION if backend == 'gloo' and world == 4
            else PAR_FORMS_N[world])
# the kinds built by the registry (`init_model`) with their bundle's loss
PAR_FAMILIES = ('wav2vec2', 'paraformer', 'whisper', 'branchformer',
                'transducer')
PAR_WHISPER_LAYERS = 4
PAR_STEPS = 2                     # a step, then the timed one
PAR_PIPE = {'stages': 2, 'microbatches': 4, 'region': PAR_LAYERS - 2}
# the 'seq' forms' batches are padded to a frame count their two ranks
# split: 2052 input frames, 512 subsampled (2051 gives 511)
PAR_SEQ_FRAMES = 2052
# the K1/K4/K5/K6 launches of a 'base' step, whatever the form (K1/K4 on
# a TP rank's H/tp heads or a 'seq' rank's queries, K5/K6 on the
# replicated rows): 5 LayerNorms a layer and after_norm, the decoder's
PAR_STEP_LAUNCHES = {'K1': PAR_LAYERS, 'K4': PAR_LAYERS,
                     'K5': 5 * PAR_LAYERS + 1 + PAR_LN_DEC,
                     'K6': 5 * PAR_LAYERS + 1 + PAR_LN_DEC}
# the f32 checks' optimizer: Adam's first step at lr 1e-3 (warm-up 1)
# with eps 1e-3, so a parameter moves by up to 1e-3, in proportion to its
# gradient below 1e-3, and agrees within PAR_F32_TOL only where its
# gradient does (reverb_large's own first step, lr 4e-8, moves nothing
# by 1e-5)
PAR_CHECK_CONF = {'optim_conf': {'lr': 1e-3, 'eps': 1e-3},
                  'scheduler_conf': {'warmup_steps': 1}}
# loss, grad norm (rel), parameters (abs) against an unwrapped step of
# the same arithmetic: the sharded step at world 1, and a data-parallel
# form against the batch split into micro-batches of a rank's rows
PAR_F32_TOL = 1e-5
# a multi-rank form against the whole batch at once.  At random init
# (a CTC loss near 1500 an utterance) the CTC term's backward amplifies
# f32 rounding: splitting the rows alone moves the gradient by ≈ 2e-4
# of its norm, the attention term's by ≈ 5e-7 (`row_split`), and a TP
# rank's split GEMMs and sums feed it other roundings of its logits
PAR_RANKS_F32_TOL = 1e-3
# the kinds whose unwrapped f32 step is rough at the scale of one f32
# ulp: the SANM Paraformer at random init, whose ReLU feed-forwards, CIF
# fires and glancing draws make its gradient a piecewise function of its
# input (moved by one ulp, the loss stays bit-equal and a leaf's gradient
# moves by ≈ 1e-2 of its norm; a smooth activation takes the parameters'
# move to 3e-7).  Their checks take PAR_ULP_CONF's optimizer, Adam with
# eps far above any clipped gradient element, so that a parameter moves
# by its gradient (Adam's first step is lr·g/(|g| + eps)) and no
# difference saturates at 2·lr as under PAR_CHECK_CONF; each parameter's
# update is compared with the reference's, ‖p − p_ref‖ / ‖p_ref − p_0‖,
# and each metric is held to twice its floor in the same run (the
# unwrapped step against itself with its input one ulp off, `par_refs`:
# 'ulp') where that exceeds PAR_RANKS_F32_TOL.  A wrong gradient on any
# leaf moves that leaf's update by its own size
PAR_ULP_KINDS = ('paraformer',)
PAR_ULP_CONF = {'optim_conf': {'lr': 1e3, 'eps': 1e3},
                'scheduler_conf': {'warmup_steps': 1}}
PAR_F32_B = 2
# a bf16 step of two ranks against the unwrapped bf16 step on the same
# batch: the two ranks' bf16 GEMMs run at other shapes (TP: the
# row-parallel outputs are sums of two bf16 partial products)
PAR_BF16_TOL = {'loss': 5e-3, 'grad_norm': 5e-2}


def par_configs(kind: str) -> dict:
    """The config of a PAR_FORMS_N model kind (the forms' comment)."""
    from reverb_tpu_torch.models import presets
    if kind == 'paraformer':
        configs = para_configs()
        configs['encoder_conf'] = dict(configs['encoder_conf'],
                                       num_blocks=PARA_LAYERS)
        configs['decoder_conf'] = {'num_blocks': PARA_LAYERS}
        configs['cif_conf'] = dict(configs['cif_conf'],
                                   threshold=PARA_REF_THRESHOLD)
        return configs
    if kind == 'whisper':
        return {'model': 'whisper', 'whisper_conf': dict(
            WHISPER_CONF, n_audio_layer=PAR_WHISPER_LAYERS,
            n_text_layer=PAR_WHISPER_LAYERS)}
    if kind == 'ts':
        configs = presets.reverb_config(vocab_size=VOCAB, **OBJ_TS_STUDENT)
    elif kind == 'wav2vec2':
        configs = objective_configs('wav2vec2', Path(tempfile.gettempdir()))
    elif kind == 'transducer':
        configs = transducer_configs()
    else:
        configs = presets_large()
    enc = dict(configs['encoder_conf'])
    if kind != 'ts':
        enc['num_blocks'] = PAR_LAYERS
        configs = dict(configs, decoder_conf=dict(configs['decoder_conf'],
                                                  **PAR_DEC))
    if kind == 'moe':
        enc.update(positionwise_layer_type='moe', n_expert=8,
                   n_expert_per_token=2)
    if kind in ('ln', 'transducer'):
        enc.update(cnn_module_norm='layer_norm')
    if kind in ('ln', 'transducer', 'moe'):
        enc.update(pipeline_stages=PAR_PIPE['stages'],
                   pipeline_microbatches=PAR_PIPE['microbatches'])
    if kind == 'branchformer':
        enc.update(FAM_ALT['branchformer'])
        configs = dict(configs, encoder='branchformer',
                       decoder='transformer')
    return dict(configs, encoder_conf=enc)


def par_model(dev, kind: str, dtype, check: bool = False):
    """(model, optimizer, the family's loss or None) of a kind from seed
    SEED (the teacher of 'ts' from SEED + 1, frozen), with
    PAR_CHECK_CONF's optimizer (PAR_ULP_CONF's for PAR_ULP_KINDS) for an
    f32 check."""
    import torch
    from reverb_tpu_torch.models.asr_model import ModelConfig, build_model
    from reverb_tpu_torch.models.registry import init_model
    from reverb_tpu_torch.train.teacher_student import TSConfig, ts_loss
    from reverb_tpu_torch.train.trainer import TrainConfig, build_optimizer
    configs = par_configs(kind)
    if check:
        configs = {**configs, **(PAR_ULP_CONF if kind in PAR_ULP_KINDS
                                 else PAR_CHECK_CONF)}
    loss_fn = None
    if kind in PAR_FAMILIES:
        bundle = init_model(dict(configs, dtype='bf16' if dtype ==
                                 torch.bfloat16 else 'fp32'),
                            torch.Generator(device=dev).manual_seed(SEED),
                            dev)
        model, loss_fn = bundle.model, bundle.loss_fn
    else:
        cfg = ModelConfig.from_config(configs).with_compute_dtype(dtype)
        model = build_model(cfg, dev, generator=torch.Generator(
            device=dev).manual_seed(SEED), train=True)
    if kind == 'ts':
        tconf = dict(presets_large(), encoder_conf=dict(
            presets_large()['encoder_conf'], num_blocks=PAR_LAYERS))
        teacher = build_model(
            ModelConfig.from_config(tconf).with_compute_dtype(dtype), dev,
            generator=torch.Generator(device=dev).manual_seed(SEED + 1))
        tsc = TSConfig(ts_weight=0.5, top_k_entries=8)

        def loss_fn(model, batch, generator=None):
            return ts_loss(model, teacher, batch, tsc, generator)
    opt, _ = build_optimizer(TrainConfig.from_config(configs), model)
    return model, opt, loss_fn


def par_batch(dev, kind: str, B: int, seed: int, seq: bool = False):
    """`train_batch` for a kind: a 'seq' form's padded to PAR_SEQ_FRAMES
    frames; wav2vec2's with its per-row draws (span masks, 100 negatives
    a frame, gumbels), so that a data rank takes its rows' draws; the
    transducer's `transducer_batch` (its joint's logits grow with U);
    Whisper's 30 s of random log-mels and `whisper_batch`'s targets (f32:
    the family has no bf16 route, its decoder's embeddings are f32, as
    in the JAX package); the SANM Paraformer's targets from its own
    vocabulary."""
    import torch
    if kind == 'whisper':
        gen = torch.Generator(device=dev).manual_seed(seed)
        mel = torch.randn((B, 2 * WHISPER_CONF['n_audio_ctx'],
                           WHISPER_CONF['n_mels']), generator=gen,
                          device=dev)
        return whisper_batch(dev, B, seed, mel)
    if kind == 'transducer':
        return transducer_batch(dev, B, seed, VOCAB)
    batch = train_batch(dev, B, seed,
                        PARA_VOCAB if kind == 'paraformer' else VOCAB)
    if seq:
        feats = batch['feats']
        batch['feats'] = torch.cat([feats, feats.new_zeros(
            (B, PAR_SEQ_FRAMES - feats.shape[1], feats.shape[2]))], 1)
    if kind == 'wav2vec2':
        cfg = par_configs(kind)
        w = cfg.get('wav2vec2_conf', {}) or {}
        n_neg = w.get('num_negatives', 100)
        G, C = w.get('num_codebooks', 1), w.get('codebook_size', 320)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        T = ((batch['feats'].shape[1] - 1) // 2 - 1) // 2
        lens = ((batch['feats_lengths'] - 1) // 2 - 1) // 2
        valid = torch.arange(T, device=dev)[None, :] < lens[:, None]
        span = (torch.rand((B, T), generator=gen, device=dev) < 0.3) & valid
        span[:, 0] = True
        u = torch.rand((B, T, G, C), generator=gen, device=dev)
        u = torch.finfo(torch.float32).tiny + (1 - 1e-7) * u
        batch.update(
            span_mask=span,
            neg_pos=torch.randint(0, T, (B, T, n_neg), generator=gen,
                                  device=dev),
            gumbels=-torch.log(-torch.log(u)))
    return batch


def pipe_launches(whole: dict, kind: str) -> dict:
    """A 'pipe' rank's launches a step from the unwrapped step's: each
    stage runs its region/S layers on each of M microbatches (6 LayerNorms
    a layer with a layer_norm conv module, 5 with batch_norm) and the
    layers around the region whole (a 'seq' rank on its time block: the
    same launches)."""
    n, S, M = PAR_PIPE['region'], PAR_PIPE['stages'], \
        PAR_PIPE['microbatches']
    ln = 6 if par_configs(kind)['encoder_conf'].get(
        'cnn_module_norm') == 'layer_norm' else 5
    per = {'K1': 1, 'K4': 1, 'K5': ln, 'K6': ln}
    return {k: v - n * per[k] + n // S * M * per[k]
            for k, v in whole.items()}


def train_launches() -> dict:
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    return {'K1': fa.LAUNCHES, 'K4': fa.BWD_LAUNCHES, 'K5': ln.LAUNCHES,
            'K6': ln.BWD_LAUNCHES}


def zero_train_launches():
    from reverb_tpu_torch.ops import flash_attention as fa
    from reverb_tpu_torch.ops import layer_norm as ln
    fa.LAUNCHES = fa.BWD_LAUNCHES = ln.LAUNCHES = ln.BWD_LAUNCHES = 0


def counted_step(step, model, batch, gen, total) -> tuple:
    """One step with the K1/K4/K5/K6 counts set to 0 before it and read
    after it: (metrics, its launches), the launches added to `total`."""
    zero_train_launches()
    metrics = step(model, batch, gen)
    got = train_launches()
    for n, v in got.items():
        total[n] = total.get(n, 0) + v
    return metrics, got


def sharded(model, opt, axes, opts, loss_fn=None):
    """The model and optimizer split over make_mesh(**axes) (the
    `Sharding` of `opts`), and their sharded step (clip 50, the form's
    accum_grad; a family's `loss_fn`)."""
    from reverb_tpu_torch.parallel import mesh as pm
    from reverb_tpu_torch.parallel.sharding import Sharding
    from reverb_tpu_torch.train.trainer import make_train_step
    opts = dict(opts)
    accum = opts.pop('accum_grad', 1)
    sh = Sharding(pm.make_mesh(**axes), **opts).apply(model, opt)
    return sh, make_train_step(model.cfg, opt, accum, 50.0, sharding=sh,
                               loss_fn=loss_fn)


def timed_steps(step, model, batch, gen, total, n=PAR_STEPS) -> tuple:
    """n counted steps: (first step's metrics, ms of the last, each step's
    launches)."""
    import torch
    metrics, walls, launches = [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, got = counted_step(step, model, batch, gen, total)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append(m)
        launches.append(got)
    return metrics[0], walls[-1] * 1e3, launches


def param_err(params, want) -> float:
    return max(float((p.detach() - w.to(p.device)).abs().max())
               for p, w in zip(params, want))


def update_errs(named, want, init) -> list:
    """[(name, ‖p − w‖ / ‖w − p_0‖, ‖w − p_0‖)] of each parameter against
    the reference `want` that moved from `init` in one step, worst
    first (a parameter the reference left where it was: 0 if it stayed
    too, else inf)."""
    errs = []
    for (n, p), w, p0 in zip(named, want, init):
        p = p.detach().cpu()
        moved = float((w - p0).norm())
        gap = float((p - w).norm())
        errs.append((n, gap / moved if moved else
                     (0.0 if gap == 0 else math.inf), moved))
    return sorted(errs, key=lambda e: -e[1])


def worst_params(model, want, k=3, init=None) -> list:
    """The k parameters farthest from `want`: [(name, max abs error,
    largest |value| of want)], or with `init` `update_errs`'."""
    if init is not None:
        return update_errs(model.named_parameters(), want, init)[:k]
    errs = [(n, float((p.detach() - w.to(p.device)).abs().max()),
             float(w.abs().max()))
            for (n, p), w in zip(model.named_parameters(), want)]
    return sorted(errs, key=lambda e: -e[1])[:k]


def row_split(dev, seed, batch, total) -> dict:
    """What splitting the f32 batch into one-row halves alone moves, by
    loss term, in one process with no collective: {term: (|Δ‖g‖| / ‖g‖,
    ‖Δg‖ / ‖g‖)} of the whole batch's gradient against the mean of the
    halves'.  The floor under a multi-rank form's comparison with the
    whole batch (PAR_RANKS_F32_TOL)."""
    import torch
    from reverb_tpu_torch.models.asr_model import compute_loss
    model = par_model(dev, 'base', torch.float32)[0]
    params = list(model.parameters())

    def grads(term, parts):
        for p in params:
            p.grad = None
        zero_train_launches()
        for part in parts:
            (compute_loss(model, part, None)[term] / len(parts)).backward()
        for n, v in train_launches().items():
            total[n] = total.get(n, 0) + v
        return [torch.zeros_like(p) if p.grad is None else p.grad
                for p in params]

    def norm(ts):
        return float(torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(ts))))
    halves = [{k: v[i:i + 1] for k, v in batch.items()}
              for i in range(batch['feats'].shape[0])]
    out = {}
    for term in ('loss_ctc', 'loss_att'):
        whole = [g.clone() for g in grads(term, [batch])]
        split = grads(term, halves)
        n = norm(whole)
        out[term] = (abs(norm(split) - n) / n,
                     norm(torch._foreach_sub(split, whole)) / n)
    log('parallel world 1, the row split alone (the whole f32 batch '
        'against the mean of its one-row halves, one process): '
        + ', '.join(f'{t} gradient norm rel {a:.2e}, ‖Δg‖/‖g‖ {b:.2e}'
                    for t, (a, b) in out.items()))
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def parallel_world1(dev, seed) -> dict:
    """World size 1 over NCCL: the sharded step (`Sharding` over a one-rank
    mesh; ZeRO and TP split nothing at one rank, so one form stands for
    all) takes the step the unwrapped one takes.  f32 (TF32 off) at
    B = PAR_F32_B with dropout 0.1 (both from a generator of seed 7) and
    PAR_CHECK_CONF's optimizer: loss and grad norm within PAR_F32_TOL
    relative and every parameter within PAR_F32_TOL of the unwrapped
    step's, every K1, K4, K5 and K6 call of the step held to its plain
    version on its own inputs (`checked_kernels`, RECIPE_CALL_TOL) and
    counted.  Then bf16 at B = 8: its ms a step and peak memory, and the
    unwrapped step without dropout, which the multi-rank forms are held
    to.  Every step's launches are counted into 'total'.  reverb_large at
    PAR_LAYERS layers throughout."""
    import torch
    import torch.distributed as dist
    from reverb_tpu_torch.parallel import mesh as pm
    from reverb_tpu_torch.train.trainer import make_train_step
    pm.init_distributed(f'file://{tempfile.mkdtemp()}/pg', 1, 0, dev)
    total = {}
    out = {'total': total}
    try:
        batch = train_batch(dev, PAR_F32_B, seed + 1, VOCAB)
        model, opt, _ = par_model(dev, 'base', torch.float32, check=True)
        step = make_train_step(model.cfg, opt, 1, 50.0)
        want, _ = counted_step(step, model, batch, torch.Generator(
            device=dev).manual_seed(7), total)
        want_p = [p.detach().clone() for p in model.parameters()]
        del model, opt, step
        model, opt, _ = par_model(dev, 'base', torch.float32, check=True)
        sh, step = sharded(model, opt, {}, {'zero3': True})
        errs = {}
        with swapped(checked_kernels(errs)):
            got, launches = counted_step(
                step, model, batch, torch.Generator(device=dev).manual_seed(7),
                total)
        check_call_errs(errs, 'parallel world 1, the sharded step')
        rel = {k: abs(got[k] - want[k]) / abs(want[k])
               for k in ('loss', 'grad_norm')}
        dp = param_err(model.parameters(), want_p)
        log(f'parallel world 1 (NCCL), the sharded step, f32 B={PAR_F32_B}: '
            f'loss {got["loss"]:.6f} vs unwrapped {want["loss"]:.6f} (rel '
            f'{rel["loss"]:.2e}), grad norm {got["grad_norm"]:.6f} vs '
            f'{want["grad_norm"]:.6f} (rel {rel["grad_norm"]:.2e}), '
            f'parameters within {dp:.2e}; launches {launches}, each call '
            f'against its plain version, worst share of scale '
            + ', '.join(f'{n} {e:.2e}' for n, e in sorted(errs.items())))
        if launches != PAR_STEP_LAUNCHES or not (
                max(rel.values()) <= PAR_F32_TOL and dp <= PAR_F32_TOL):
            raise AssertionError(f'parallel world 1: not the unwrapped '
                                 f'step, or launches {launches} != '
                                 f'{PAR_STEP_LAUNCHES}')
        out['f32'] = {'rel': rel, 'param_err': dp, 'launches': launches,
                      'call_errs': errs}
        del model, opt, step, sh, want_p
        gc.collect()
        torch.cuda.empty_cache()
        out['row_split'] = row_split(dev, seed, batch, total)
        batch = train_batch(dev, TRAIN_B, seed + 2, VOCAB)
        model, opt, _ = par_model(dev, 'base', torch.bfloat16)
        step = make_train_step(model.cfg, opt, 1, 50.0)
        out['unwrapped_bf16'], _ = counted_step(step, model, batch, None,
                                                total)
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, opt, _ = par_model(dev, 'base', torch.bfloat16)
        sh, step = sharded(model, opt, {}, {'zero3': True})
        gen = torch.Generator(device=dev).manual_seed(seed + 3)
        _, ms, launches = timed_steps(step, model, batch, gen, total)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if any(got != PAR_STEP_LAUNCHES for got in launches):
            raise AssertionError(f'parallel world 1, bf16: launches '
                                 f'{launches} != {PAR_STEP_LAUNCHES} a step')
        out['bf16'] = {'ms': ms, 'peak_gib': peak, 'launches': launches[0]}
        log(f'parallel world 1 (NCCL), the sharded step, bf16 B={TRAIN_B}: '
            f'{ms:.1f} ms a step, peak {peak:.2f} GiB, launches a step '
            f'{launches[0]}')
        del model, opt, step, sh
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def par_f32_rows(axes, opts) -> int:
    """The f32 check's rows: PAR_F32_B, one a microbatch for a 'pipe'
    form (so that its GPipe region runs), one a micro-batch of each data
    rank with accum_grad."""
    if 'pipe' in axes:
        return PAR_PIPE['microbatches']
    return max(PAR_F32_B, axes.get('data', 1) * opts.get('accum_grad', 1))


def form_dropout(axes) -> bool:
    """Whether a form's f32 check draws dropout: where the data axis is 1
    every rank draws the unwrapped step's masks (a split layer its block
    of them), except under 'pipe', whose stages draw per (layer,
    microbatch) generators."""
    return axes.get('data', 1) == 1 and 'pipe' not in axes


def parallel_child(spec: str) -> int:
    """One rank of a multi-rank run (`--parallel-child rank,world,backend,
    dir`), through `parallel.mesh.init_distributed`.  Rank 0 first takes
    the unwrapped f32 steps the forms are held to (`par_refs`).  Then
    every form of `par_forms(backend, world)` in turn:

    - f32 (TF32 off) at B = PAR_F32_B, PAR_CHECK_CONF's optimizer, the
      rank's rows; dropout from `dropout_generator(7, ...)` where
      `form_dropout` (every rank draws the unwrapped step's masks), none
      where data ranks draw their own.  Rank 0's K1/K4/K5/K6 calls are
      held to their plain versions (`checked_kernels`, with the (Tq, Tk)
      of every K1 call), and its metrics and gathered parameters compared
      with each reference of the form;
    - a 'base' form, and every form under NCCL: bf16 at B = 8 (the
      rank's rows), no dropout: the first step's metrics, ms of the
      last; the other forms under gloo (one card): the f32 model's next
      step, timed.  Peak GiB of the timed steps.

    Every step's launches are read, and 'seq' forms' split steps counted.
    Writes {form: results} or {form: error, whether it came from a
    collective}, the launches each form's steps must take ('expect') and
    the rank's launches in all ('total'), to dir/rank<r>_<backend>.json.
    A form that raises inside torch.distributed is recorded (gloo carries
    some collectives for CUDA tensors only); any other error fails the
    rank."""
    import traceback
    import torch
    import torch.distributed as dist
    from reverb_tpu_torch.parallel import mesh as pm
    rank, world, backend, workdir = spec.split(',')
    rank, world = int(rank), int(world)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = pm.init_distributed(
        f'file://{workdir}/pg_{backend}', world, rank,
        f'cuda:{rank if backend == "nccl" else 0}', backend=backend)
    total = {}
    refs = par_refs(dev, par_forms(backend, world), total) \
        if rank == 0 else {}
    out = {'expect': {}}
    for name, axes, opts, kind in par_forms(backend, world):
        gc.collect()
        torch.cuda.empty_cache()
        model = opt = step = sh = None
        seq, pipe = 'seq' in axes, 'pipe' in axes
        ref = refs.get(par_ref_key(axes, opts, kind), {})
        res = out[name] = {}
        try:
            f32_batch = par_batch(dev, kind, par_f32_rows(axes, opts),
                                  SEED + 1, seq)
            model, opt, loss_fn = par_model(dev, kind, torch.float32,
                                            check=True)
            sh, step = sharded(model, opt, axes, opts, loss_fn)
            drop = form_dropout(axes)
            gen = pm.dropout_generator(7, sh.mesh, dev) if drop else None
            errs, shapes = {}, set()
            with swapped(checked_kernels(errs, shapes) if rank == 0 else {}):
                m32, got = counted_step(step, model,
                                        pm.local_rows(f32_batch, sh.mesh),
                                        gen, total)
            res['f32'] = {'metrics': m32, 'launches': got, 'dropout': drop,
                          'call_errs': errs, 'against': {},
                          'k1_tq_tk': sorted(shapes)}
            floor = ref.get('floor', {})
            tol = {k: max(PAR_RANKS_F32_TOL, 2 * floor.get(k, 0.0))
                   for k in ('loss', 'grad_norm', 'params')}
            keys = (('dropout', tol),) if drop else (('whole', tol),)
            if kind == 'base' and set(axes) == {'data'}:
                keys += (('rows', dict.fromkeys(tol, PAR_F32_TOL)),)
            init = ref.get('init')
            with sh.gathered():
                for key, tol in keys if rank == 0 else ():
                    want, want_p = ref[key]
                    worst = worst_params(model, want_p, init=init)
                    res['f32']['against'][key] = {
                        'tol': tol, 'update': init is not None,
                        'rel': {k: abs(m32[k] - want[k]) / abs(want[k])
                                for k in ('loss', 'grad_norm')},
                        'param_err': (worst[0][1] if init is not None else
                                      param_err(model.parameters(), want_p)),
                        'worst': worst}
            if rank == 0:
                whole = ref['launches']
                out['expect'][name] = (pipe_launches(whole, kind)
                                       if 'pipe' in axes else whole)
            if backend == 'gloo' and kind != 'base':
                # one card over gloo: the f32 model's next step is timed
                # (the bf16 model and its steps are cut for the all-phase
                # run's time, but for the 'base' forms, whose bf16 step is
                # held to the unwrapped one; NCCL on several cards runs
                # every form's), after a barrier: rank 0 compared the
                # first step with its references meanwhile
                dist.barrier()
                torch.cuda.reset_peak_memory_stats(dev)
                metrics, ms, launches = timed_steps(
                    step, model, pm.local_rows(f32_batch, sh.mesh), gen,
                    total, 1)
                timed = ('f32', par_f32_rows(axes, opts))
            else:
                del model, opt, step, sh
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                model, opt, loss_fn = par_model(dev, kind, torch.bfloat16)
                sh, step = sharded(model, opt, axes, opts, loss_fn)
                metrics, ms, launches = timed_steps(
                    step, model, pm.local_rows(par_batch(
                        dev, kind, TRAIN_B, SEED + 2, seq), sh.mesh), None,
                    total)
                timed = ('bf16' if kind != 'whisper' else 'f32', TRAIN_B)
            res.update(metrics=metrics, ms=ms, launches=launches,
                       timed=timed,
                       peak_gib=torch.cuda.max_memory_allocated(dev)
                       / 2**30,
                       seq_steps=dict(model.encoder.seq_steps))
        except Exception as e:              # noqa: BLE001 (recorded)
            frames = traceback.extract_tb(e.__traceback__)
            if not any('torch/distributed' in f.filename for f in frames):
                raise
            out[name] = {'error': f'{type(e).__name__}: {e}'[:400]}
        del model, opt, step, sh
    out['total'] = total
    with open(Path(workdir) / f'rank{rank}_{backend}.json', 'w') as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def par_ref_key(axes, opts, kind) -> tuple:
    """What a form's unwrapped reference step depends on: (kind, 'seq'
    form (its batch padded: the dropout masks' shapes follow the frames),
    'pipe' form, accum_grad, the f32 check's rows)."""
    return (kind, 'seq' in axes, 'pipe' in axes, opts.get('accum_grad', 1),
            par_f32_rows(axes, opts))


def par_refs(dev, forms, total) -> dict:
    """The unwrapped f32 steps (`par_model`'s check) on the whole f32 batch
    that the multi-rank `forms` are held to, by `par_ref_key`:
    {key: {run: (metrics, parameters in host memory, so the bf16 peaks
    stay the forms' own), 'launches': the 'whole' step's}}.  Runs: 'whole'
    without dropout (at the forms' accum_grad), 'dropout' with a generator
    of seed 7 where a form draws dropout, and for the 'base' data-parallel
    forms 'rows': the batch as one micro-batch (accum_grad) for each data
    rank, no dropout — the row split's own arithmetic, which that form's
    sums repeat.  For PAR_ULP_KINDS also 'init' (the parameters before
    the step), 'ulp' (the held run with its input one ulp off) and
    'floor' (how far 'ulp' lies from the held run, by metric)."""
    import torch
    from reverb_tpu_torch.train.trainer import make_train_step
    refs = {}
    for ref in dict.fromkeys(par_ref_key(axes, opts, k)
                             for _, axes, opts, k in forms):
        kind, seq, _, accum, rows = ref
        meshes = [axes for _, axes, opts, k in forms
                  if par_ref_key(axes, opts, k) == ref]
        runs = [('whole', accum, None)]
        if any(form_dropout(axes) for axes in meshes):
            runs.append(('dropout', accum, 7))
        held = runs[-1]            # the run the forms are held to
        if kind in PAR_ULP_KINDS:
            runs.append(('ulp', accum, held[2]))
        runs += [('rows', n, None) for n in {
            axes['data'] for axes in meshes
            if kind == 'base' and set(axes) == {'data'}}]
        refs[ref] = {}
        batch = par_batch(dev, kind, rows, SEED + 1, seq)
        for key, n, seed in runs:
            model, opt, loss_fn = par_model(dev, kind, torch.float32,
                                            check=True)
            if kind in PAR_ULP_KINDS and 'init' not in refs[ref]:
                names = [nm for nm, _ in model.named_parameters()]
                refs[ref]['init'] = [p.detach().cpu()
                                     for p in model.parameters()]
            step = make_train_step(model.cfg, opt, n, 50.0,
                                   loss_fn=loss_fn)
            gen = None if seed is None else torch.Generator(
                device=dev).manual_seed(seed)
            b = batch if key != 'ulp' else dict(
                batch, feats=batch['feats'] * (1 + 2 ** -23))
            metrics, got = counted_step(step, model, b, gen, total)
            refs[ref][key] = (
                metrics, [p.detach().cpu() for p in model.parameters()])
            if key == 'whole':
                refs[ref]['launches'] = got
            del model, opt, step
            gc.collect()
            torch.cuda.empty_cache()
        if 'ulp' in refs[ref]:
            # the unwrapped step against itself with its input one ulp off
            (m0, p0), (m1, p1) = refs[ref][held[0]], refs[ref]['ulp']
            floor = {k: abs(m1[k] - m0[k]) / abs(m0[k])
                     for k in ('loss', 'grad_norm')}
            worst = update_errs(zip(names, p1), p0, refs[ref]['init'])
            floor['params'] = worst[0][1]
            refs[ref]['floor'] = floor
            log(f'parallel {kind}: the unwrapped f32 step against itself '
                f'with its input moved by one ulp: loss rel '
                f'{floor["loss"]:.2e}, grad norm rel '
                f'{floor["grad_norm"]:.2e}, worst updates (‖Δ‖ / ‖update‖) '
                + ', '.join(f'{n} {e:.2e} of {w:.2e}' for n, e, w in
                            worst[:3]))
    return refs


def wait_all(procs, timeout: float) -> list:
    """Exit codes of `procs`; the first to fail, or the time limit, stops
    the rest (a rank left in a collective would wait for its peer)."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs]


def parallel_ranks(backend: str, want: dict, world: int = 2) -> dict:
    """The run of `world` ranks over `backend`: processes of this script
    (all on cuda:0 under gloo; cuda:r under NCCL).  Each form's f32 step
    is held to the unwrapped f32 step of its kind (PAR_F32_TOL or
    PAR_RANKS_F32_TOL on loss, grad norm and every parameter, twice the
    floor for PAR_ULP_KINDS; rank 0's kernel calls to RECIPE_CALL_TOL), a
    'base' form's bf16 step to the unwrapped bf16 step (PAR_BF16_TOL;
    the other timed steps finite and equal across ranks), every rank's
    every step to the
    launches rank 0 expects of the form, 'seq' forms' K1 calls to Tq ≠ Tk
    and their steps to split, and the ranks to one another.  A 'pipe'
    form reports its bubble share, (S − 1)/(M + S − 1).  A form that
    raises in a collective is reported on its own line: every form must
    run, under gloo (which carries CUDA tensors through the port's host
    copies where it lacks a collective) as under NCCL."""
    workdir = tempfile.mkdtemp(prefix='reverb_par_')
    procs = [subprocess.Popen([sys.executable, str(ROOT / 'chip_smoke.py'),
                               '--parallel-child',
                               f'{r},{world},{backend},{workdir}'])
             for r in range(world)]
    codes = wait_all(procs, 900)
    what = f'parallel {backend} x{world}'
    if codes != [0] * world:
        raise AssertionError(f'{what}: ranks exited {codes}')
    ranks = [json.loads((Path(workdir) / f'rank{r}_{backend}.json')
                        .read_text()) for r in range(world)]
    where = 'one card' if backend == 'gloo' else f'{world} cards'
    failed = []
    for name, axes, opts, kind in par_forms(backend, world):
        rs = [r[name] for r in ranks]
        errors = [r['error'] for r in rs if 'error' in r]
        if errors:
            log(f'{what} on {where}: {name} cannot run: {errors[0]}')
            raise AssertionError(f'{what}: {name} failed')
        try:
            expect = ranks[0]['expect'][name]
            f32 = rs[0]['f32']
            # the kernels the unwrapped step launches (no K1/K4 without
            # rel-pos attention: the SANM Paraformer, Whisper)
            check_call_errs(f32['call_errs'],
                            f'{what}: {name}, rank 0\'s f32 step',
                            [k for k, n in expect.items() if n])
            m = rs[0]['metrics']
            dtype, rows = rs[0]['timed']
            # a reverb_large bf16 step is held to the unwrapped bf16 step
            bf16_base = kind == 'base' and dtype == 'bf16'
            rel = {k: abs(m[k] - want[k]) / abs(want[k])
                   for k in PAR_BF16_TOL}
            steps = [r['f32']['launches'] for r in rs] + [
                got for r in rs for got in r['launches']]
            extra = ''
            if 'pipe' in axes:
                S, M = PAR_PIPE['stages'], PAR_PIPE['microbatches']
                extra = (f'; bubbles {S - 1} of {M + S - 1} ticks '
                         f'({(S - 1) / (M + S - 1):.1%})')
            if 'seq' in axes:
                extra = (f'; K1 (Tq, Tk) {f32["k1_tq_tk"]}, split steps '
                         f'{rs[0]["seq_steps"]}')
                if not f32['k1_tq_tk'] or any(tq == tk for tq, tk in
                                              f32['k1_tq_tk']) or \
                        any(r['seq_steps']['whole'] for r in rs):
                    raise AssertionError(f'{what}: {name} did not split its '
                                         f'time axis{extra}')
            log(f'{what} on {where}: {name} ({kind}): f32 B='
                f'{par_f32_rows(axes, opts)} '
                f'({"with" if f32["dropout"] else "without"} dropout) against '
                f'the unwrapped step '
                + '; '.join(f'({key}, tolerances '
                            + ' / '.join(f'{t:.2e}' for t in
                                         a['tol'].values())
                            + f'): loss rel {a["rel"]["loss"]:.2e}, grad '
                            f'norm rel {a["rel"]["grad_norm"]:.2e}, '
                            + ('updates (‖Δ‖ / ‖update‖)' if a['update']
                               else 'parameters')
                            + f' within {a["param_err"]:.2e} (worst: '
                            + ', '.join(f'{n} {e:.2e} of {w:.2e}'
                                        for n, e, w in a['worst']) + ')'
                            for key, a in f32['against'].items())
                + '; rank 0\'s calls against their plain versions, worst '
                'share of scale '
                + ', '.join(f'{n} {e:.2e}' for n, e in
                            sorted(f32['call_errs'].items()))
                + f'; {dtype} B={rows} (timed): loss {m["loss"]:.5f}'
                + (f' vs unwrapped {want["loss"]:.5f} (rel {rel["loss"]:.2e}), '
                   f'grad norm {m["grad_norm"]:.4f} vs {want["grad_norm"]:.4f} '
                   f'(rel {rel["grad_norm"]:.2e})' if bf16_base else
                   f', grad norm {m["grad_norm"]:.4f}')
                + '; ms a step by rank '
                + ' / '.join(f'{r["ms"]:.1f}' for r in rs) + ', peak GiB by rank '
                + ' / '.join(f'{r["peak_gib"]:.2f}' for r in rs)
                + f'; rank 0\'s launches a step {rs[0]["launches"][0]}{extra}')
            if any(s != expect for s in steps):
                raise AssertionError(f'{what}: {name}: launches a step {steps} '
                                     f'!= {expect}')
            if any(a['param_err'] > a['tol']['params'] or
                   any(a['rel'][k] > a['tol'][k] for k in a['rel'])
                   for a in f32['against'].values()) or \
                    not f32['against'] or \
                    any(r['f32']['metrics'] != f32['metrics'] for r in rs):
                raise AssertionError(f'{what}: {name}: the f32 step differs '
                                     f'from the unwrapped one, or between '
                                     f'ranks')
            if (bf16_base and any(rel[k] > PAR_BF16_TOL[k] for k in rel)) \
                    or any(r['metrics'] != m for r in rs) or \
                    m['skipped'] != 0.0 or not math.isfinite(m['loss']):
                raise AssertionError(f'{what}: {name} differs from the '
                                     f'unwrapped step (tolerances '
                                     f'{PAR_BF16_TOL}) or between ranks')
        except AssertionError as e:     # every form is reported
            log(f'{what} on {where}: {name} FAILED: {e}')
            failed.append(name)
    if failed:
        raise AssertionError(f'{what}: {failed} failed (above)')
    total = {}
    for r in ranks:
        for n, v in r['total'].items():
            total[n] = total.get(n, 0) + v
    return {'ranks': ranks, 'total': total}


def ctm_rows_differing(a, b) -> int:
    return sum(x != y for ga, gb in zip(a, b)
               for x, y in zip(ga.splitlines(), gb.splitlines())) + sum(
        abs(len(ga.splitlines()) - len(gb.splitlines()))
        for ga, gb in zip(a, b))


def parallel_serve(asr, wav) -> dict:
    """`ReverbASR(data_parallel=device_count)` on the serve phase's file:
    its one batch of 8 chunks goes to the replicas in blocks of 8/N rows,
    and its CTM must be, byte for byte, that of data_parallel=0 decoding
    the same blocks (batch_size 8/N): in bf16 a block's GEMM and
    convolution algorithms, so its rounding, follow its row count, so
    against data_parallel=0's default batch of 8 the rows that differ are
    reported, not asserted.  Launches of the timed call, and of the four
    calls in all ('total')."""
    import torch
    from reverb_tpu_torch.cli.reverb import ReverbASR
    n = torch.cuda.device_count()
    dp = ReverbASR.from_model(asr.configs, asr.model, asr.tokenizer,
                              data_parallel=n)
    per = -(-N_CHUNKS // n)
    total = {}

    def call(model, **kwargs):
        zero_launch_counts()
        res = transcribe_s(model, wav, MODES, **kwargs)
        got = launch_counts()
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return res, got
    (_, want), _ = call(asr, batch_size=per)
    (_, whole), _ = call(asr)
    call(dp)                                    # the replicas' first call
    (wall, got), launches = call(dp)
    if got != want or not all(got):
        raise AssertionError(f'data_parallel={n}: the CTM differs from one '
                             f'replica\'s on the same row blocks '
                             f'({ctm_rows_differing(got, want)} rows)')
    apart = ctm_rows_differing(got, whole)
    log(f'parallel serving: data_parallel={n} ({len(dp.replicas)} '
        f'replicas, blocks of {per} chunks) CTM byte-identical to '
        f'data_parallel=0 at batch_size {per}; {apart} of '
        f'{sum(len(c.splitlines()) for c in whole)} CTM rows differ from '
        f'its default batch of {N_CHUNKS}; {wall:.4f} s a call, launches '
        f'{launches}')
    del dp
    return {'n': n, 'wall': wall, 'launches': launches, 'total': total,
            'rows_apart_from_default_batch': apart}


def run_parallel(dev, seed=SEED) -> dict:
    """Phase `parallel` (the serving check runs in the serving block):
    world size 1 over NCCL, two ranks on one card over gloo, four ranks
    on one card over gloo (PAR_FORMS_REGION), two and four ranks over
    NCCL where there are the cards."""
    import torch
    smi = smi_line()
    t0 = time.perf_counter()
    res = {'world1': parallel_world1(dev, seed)}
    res['gloo'] = parallel_ranks('gloo', res['world1']['unwrapped_bf16'])
    t1 = time.perf_counter()
    res['gloo4'] = parallel_ranks('gloo', res['world1']['unwrapped_bf16'],
                                  4)
    log(f'parallel gloo x4 (the GPipe region under \'seq\' and '
        f'\'expert\'): {time.perf_counter() - t1:.1f} s on {smi}')
    n = torch.cuda.device_count()
    for world in (2, 4):
        if n >= world:
            res[f'nccl{world}'] = parallel_ranks(
                'nccl', res['world1']['unwrapped_bf16'], world)
        else:
            log(f'parallel nccl x{world}: {n} card(s); the NCCL run of '
                f'{world} ranks needs {world}')
    log(f'parallel: {time.perf_counter() - t0:.1f} s on {smi}')
    return res


# ------------------------------ phase 20: the model families -------------

FAM_LAYERS = 6                 # alternative encoders, MoE training
FAM_B, FAM_STEPS = 4, 3        # transducer bf16 steps: B, count
FAM_FRAMES = (800, 1000)       # transducer utterances' feature frames
FAM_MAX_U = 32                 # and their most target tokens
FAM_BEAM = 4
FAM_HOST_SEARCHES = ('default', 'alsd', 'nsc', 'maes')
FAM_MOE = {'positionwise_layer_type': 'moe', 'n_expert': 8,
           'n_expert_per_token': 2}
FAM_ALT = {'branchformer': {'cgmlp_linear_units': 4096},
           'e_branchformer': {'cgmlp_linear_units': 4096,
                              'ffn_units': 4096},
           'squeezeformer': {'reduce_idx': 2, 'recover_idx': 5},
           'efficient_conformer': {}}
# rel-pos attention layers (K1/K4 a step) of each alternative encoder at
# FAM_LAYERS: the Efficient Conformer's layers 0-3 are grouped (plain
# matmuls), Squeezeformer's attention has its rel_shift (plain matmuls)
FAM_ALT_K1 = {'branchformer': FAM_LAYERS, 'e_branchformer': FAM_LAYERS,
              'squeezeformer': 0, 'efficient_conformer': FAM_LAYERS - 4}
FAM_BIN_WAVS, FAM_BIN_CV = 8, 2          # bin.train's corpus, 6-10 s each


def expect_launches(got: dict, want: dict, what: str):
    """Raise unless the launches `got` are exactly `want`."""
    log(f'{what}: launches {got}, expected {want}')
    if got != want:
        raise AssertionError(f'{what}: the path did not run every kernel '
                             f'the expected number of times')


def log_call_errs(errs: dict, what: str):
    log(f'{what}: every kernel call against its plain version, worst '
        f'share of scale ' + ', '.join(f'{n} {e:.2e}'
                                      for n, e in sorted(errs.items())))


def as_f64(model):
    """A float64 copy of a registry model, its configs' compute dtype f64
    (the yardstick of `family_reference`, run with `f64_versions`)."""
    import copy
    import dataclasses as dc
    import torch
    from reverb_tpu_torch.models.asr_model import ModelConfig
    from reverb_tpu_torch.models.decoder import DecoderConfig
    m = copy.deepcopy(model).double()
    for mod in m.modules():
        c = getattr(mod, 'cfg', None)
        if isinstance(c, ModelConfig):
            mod.cfg = c.with_compute_dtype(torch.float64)
        elif isinstance(c, DecoderConfig):
            mod.cfg = dc.replace(c, compute_dtype=torch.float64)
        tc = getattr(mod, 'train_cfg', None)     # the SANM Paraformer's
        if tc is not None:
            mod.train_cfg = dc.replace(tc, compute_dtype=torch.float64)
    return m


def family_reference(model, loss_fn, batch, dev, kernels, what,
                     train_tol: bool = False) -> dict:
    """One f32 loss + backward (TF32 off, dropout 0.1 from a seeded
    generator) through the kernels, every kernel call held to its plain
    version on the call's own inputs (`checked_kernels`), one through the
    plain versions with the same draws, and one in f64 (`as_f64`,
    `f64_versions`): the loss within 1e-5 relative of the plain one, and
    the kernels' gradient no further from the f64 gradient than twice the
    plain f32 gradient is (`recipe_reference_check`'s rule: at random
    init a deep net's backward amplifies rounding, so the plain f32
    gradient itself can sit 1e-4 from the f64 one); with `train_tol` also
    the train phase's 1e-4 globally and 1e-3 per tensor against the plain
    run.  Returns the kernel run's launches, the call errors and the
    distances."""
    import torch
    names = [n for n, _ in model.named_parameters()]
    errs = {}
    diar_zero_launch_counts()
    loss_k, g_k = loss_and_grads(model, batch, dev, checked_kernels(errs),
                                 loss_fn)
    launches = diar_launch_counts()
    loss_p, g_p = loss_and_grads(model, batch, dev, plain_versions(),
                                 loss_fn)
    log_call_errs(errs, what)
    check_call_errs(errs, what, kernels)
    m64 = as_f64(model)
    b64 = {k: v.double() if v.is_floating_point() else v
           for k, v in batch.items()}
    loss_d, g_d = loss_and_grads(m64, b64, dev, f64_versions(), loss_fn)
    del m64, b64
    worst, where, glob = grad_worst(g_k, g_p, names)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    dist = {'kernels vs plain': glob, 'kernels vs f64': grad_dist(g_k, g_d),
            'plain vs f64': grad_dist(g_p, g_d)}
    log(f'{what}: f32 kernels vs plain: loss {loss_k:.6f} vs {loss_p:.6f} '
        f'(rel {rel:.2e}), f64 {loss_d:.6f}; gradient distances '
        + ', '.join(f'{n} {d:.2e}' for n, d in dist.items())
        + f'; worst tensor against plain {worst:.2e} ({where})')
    ok = (rel <= 1e-5
          and dist['kernels vs f64'] <= 2 * dist['plain vs f64'])
    if train_tol:
        ok = ok and glob <= 1e-4 and worst <= 1e-3
    if not ok:
        raise AssertionError(f'{what}: kernels differ from the plain '
                             f'versions')
    del g_k, g_p, g_d
    torch.cuda.empty_cache()
    return {'launches': launches, 'call_errs': errs, 'loss_rel': rel,
            'grad_worst': worst, **dist}


def family_steps(model, loss_fn, batch, dev, seed, n, what) -> dict:
    """n steps of make_train_step with the bundle's loss (Adam, warmuplr,
    clip 50, dropout from a seeded generator): ms a step (mean of steps
    2-n), audio-s/s, peak memory, the launches of every step (each the
    same), finite losses."""
    import torch
    from reverb_tpu_torch.train.trainer import (TrainConfig,
                                                build_optimizer,
                                                make_train_step)
    tc = TrainConfig.from_config(presets_large())
    opt, _ = build_optimizer(tc, model)
    step = make_train_step(model.cfg, opt, tc.accum_grad, tc.grad_clip,
                           loss_fn=loss_fn)
    gen = torch.Generator(device=dev).manual_seed(seed)
    audio_s = float(batch['feats_lengths'].sum()) / 100.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, metrics, launches, ln_seen = [], [], [], []
    ln_calls, hooks = ln_call_counter(model)
    try:
        for _ in range(n):
            diar_zero_launch_counts()
            ln_calls[0] = 0
            t0 = time.perf_counter()
            metrics.append(step(model, batch, gen))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches.append(diar_launch_counts())
            ln_seen.append(ln_calls[0])
    finally:
        for h in hooks:
            h.remove()
    peak = torch.cuda.max_memory_allocated()
    for m in metrics:
        if not (math.isfinite(m['loss']) and math.isfinite(m['grad_norm'])
                and m['skipped'] == 0.0):
            raise AssertionError(f'{what}: step {m}')
    if any(lc != launches[0] for lc in launches) or \
            any(c != ln_seen[0] for c in ln_seen):
        raise AssertionError(f'{what}: launches differ by step {launches} '
                             f'(LayerNorm calls {ln_seen})')
    ms = (sum(walls[1:]) / (n - 1) if n > 1 else walls[0]) * 1e3
    res = {'ms': ms, 'first_ms': walls[0] * 1e3, 'audio_s': audio_s,
           'steps': n,
           'audio_s_per_s': audio_s / ms * 1e3, 'peak_gib': peak / 2 ** 30,
           'launches': launches[0], 'ln_calls': ln_seen[0],
           'losses': [m['loss'] for m in metrics]}
    dtype = getattr(model.cfg, 'compute_dtype', torch.float32)
    log(f'{what}: {n} {"bf16" if dtype == torch.bfloat16 else "f32"} '
        f'steps at B={batch["feats"].shape[0]} '
        f'({audio_s:.2f} s of audio a step): {ms:.1f} ms a step (first '
        f'{res["first_ms"]:.1f}), {res["audio_s_per_s"]:.1f} audio-s/s, '
        f'peak {res["peak_gib"]:.2f} GiB; losses '
        f'{[round(x, 3) for x in res["losses"]]}; launches a step '
        f'{launches[0]}')
    del opt, step
    return res


def presets_large() -> dict:
    from reverb_tpu_torch.models import presets
    return presets.reverb_large()


# ---- (b) MoE ------------------------------------------------------------

def family_moe(dev, seed, workdir: Path, wav, audio_s) -> dict:
    """reverb_large with the MoE feed-forward (8 experts, 2 a token;
    WeNet's U2++-MoE setting) in every FFN: the serving check of phase
    serve (one f32 chunk: the encoder's K1/K5 against the plain versions,
    the decode tail identical on its output), then a warm-up and a timed
    bf16 transcribe_modes call on the 164 s file (K1 18, K2 = K3 = 1 an
    encoder call, K5 at every LayerNorm), whose CTM the same call with
    K2/K3 swapped for their plain versions reproduces byte for byte; the
    same call on an f32 copy through the kernels and through every plain
    version, its CTM byte-equal; then at FAM_LAYERS layers one f32
    reference step and one timed bf16 step."""
    import gc
    import torch
    from reverb_tpu_torch.cli import reverb as rv
    from reverb_tpu_torch.cli.reverb import ReverbASR
    from reverb_tpu_torch.models.asr_model import build_model
    from reverb_tpu_torch.ops import beam_scan as bs
    asr = build_asr(dev, seed, workdir, FAM_MOE)
    feats = asr.compute_feats(str(wav))
    q = sharpen_ctc_head(asr, feats)
    n_params = sum(p.numel() for p in asr.model.parameters())
    log(f'moe: {n_params / 1e9:.3f}B parameters; ctc head x8, blank bias '
        f'+{q:.3f}')
    # the uncapped tail's rescoring sums ~120 decoder log-probs in f32
    # near -1000 (one f32 spacing is 6.1e-5), through LayerNorms that are
    # K5 in one run and plain in the other: 16 spacings, 1e-6 of the score
    reference_check(asr, feats, dev, ulps=16)
    captured = []
    decode_fn = rv.decode_modes_fn

    def recording_decode(*args, **kwargs):
        out = decode_fn(*args, **kwargs)
        captured.append(out)
        return out
    ln_calls, hooks = ln_call_counter(asr.model)
    walls, ctms = [], []
    try:
        for _ in range(2):
            captured.clear()
            ln_calls[0] = 0
            diar_zero_launch_counts()
            rv.decode_modes_fn = recording_decode
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ctms.append(asr.transcribe_modes(str(wav), MODES, format='ctm'))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            rv.decode_modes_fn = decode_fn
        launches, n_enc = diar_launch_counts(), len(captured)
        calls = ln_calls[0]
        with swapped({(bs, 'beam_scan_forward'): bs.beam_scan_forward_plain,
                      (bs, 'beam_backtrace'): bs.beam_backtrace_plain}):
            plain_ctm = asr.transcribe_modes(str(wav), MODES, format='ctm')
    finally:
        rv.decode_modes_fn = decode_fn
        for h in hooks:
            h.remove()
    expect_launches(launches, {'K1': LAYERS_ENC * n_enc, 'K2': n_enc,
                               'K3': n_enc, 'K4': 0, 'K5': calls, 'K6': 0},
                    f'moe serving ({n_enc} encoder calls)')
    if calls < LN_ENC * n_enc:
        raise AssertionError('moe serving: fewer LayerNorm calls than the '
                             'encoder has')
    for mode, ctm in zip(MODES, ctms[1]):
        if not check_ctm_rows(ctm, wav.name, f'moe {mode}'):
            raise AssertionError(f'moe serving: empty {mode} CTM')
    if plain_ctm != ctms[1]:
        raise AssertionError('moe serving: the CTM with K2/K3 plain differs')
    # the whole call in f32, through the kernels and through every plain
    # version (K1, K5, K2, K3): the CTM byte-equal
    f32 = ReverbASR.from_model(asr.configs, build_model(
        asr.model.cfg.with_compute_dtype(torch.float32), dev,
        state_dict=asr.model.state_dict()), asr.tokenizer)
    f32_ctm = f32.transcribe_modes(str(wav), MODES, format='ctm')
    with swapped({(bs, 'beam_scan_forward'): bs.beam_scan_forward_plain,
                  (bs, 'beam_backtrace'): bs.beam_backtrace_plain,
                  **plain_versions()}):
        f32_plain = f32.transcribe_modes(str(wav), MODES, format='ctm')
    del f32
    if f32_plain != f32_ctm:
        rows = [sum(a != b for a, b in zip(x.splitlines(), y.splitlines()))
                for x, y in zip(f32_ctm, f32_plain)]
        raise AssertionError(f'moe serving, f32: the CTM through the plain '
                             f'versions differs ({rows} rows by mode)')
    log(f'moe serving: second call {walls[1]:.4f} s for {audio_s:.2f} s '
        f'(xRT {audio_s / walls[1]:.1f}; first {walls[0]:.4f} s); CTM rows '
        + ', '.join(f'{m} {len(c.splitlines())}'
                    for m, c in zip(MODES, ctms[1]))
        + '; byte-equal with K2/K3 plain; in f32 byte-equal with K1, K2, '
        'K3 and K5 plain')
    res = {'serve': {'walls': walls, 'launches': launches,
                     'encoder_calls': n_enc, 'params': n_params,
                     'ln_calls': calls}, 'feats': feats}
    del asr, captured
    gc.collect()
    torch.cuda.empty_cache()
    # training at FAM_LAYERS layers: f32 reference, then one bf16 step
    configs = presets_large()
    configs['encoder_conf'].update(num_blocks=FAM_LAYERS, **FAM_MOE)
    res['train'] = family_train(
        dev, seed, configs, 'moe', {'K1', 'K4', 'K5', 'K6'}, FAM_LAYERS,
        lambda B, s, vocab: train_batch(dev, B, s, vocab), TRAIN_B)
    return res


def family_train(dev, seed, configs, what, kernels, k1, batch_fn, B,
                 steps=2, train_tol=False) -> dict:
    """A registry model of `configs`: the f32 reference at B = 2
    (`family_reference`), then `steps` bf16 steps at B (the first a
    warm-up) of the same weights (one generator seed), K1 = K4 = k1 and
    K5 = K6 = the LayerNorm calls of a step."""
    import gc
    import torch
    from reverb_tpu_torch.models.registry import init_model

    def build(dtype):
        return init_model(dict(configs, dtype=dtype), torch.Generator(
            device=dev).manual_seed(seed), dev)
    bundle = build('fp32')
    n_params = sum(p.numel() for p in bundle.model.parameters())
    vocab = bundle.model.cfg.vocab_size
    ref = family_reference(bundle.model, bundle.loss_fn,
                           batch_fn(2, seed + 1, vocab), dev, kernels,
                           f'{what} reference', train_tol)
    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    bundle = build('bf16')
    res = family_steps(bundle.model, bundle.loss_fn,
                       batch_fn(B, seed + 2, vocab), dev, seed + 3, steps,
                       f'{what} ({n_params / 1e6:.1f}M params)')
    expect_launches(res['launches'], {
        'K1': k1, 'K2': 0, 'K3': 0, 'K4': k1, 'K5': res['ln_calls'],
        'K6': res['ln_calls']}, f'{what} step')
    res.update(reference=ref, params=n_params)
    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---- (a) the transducer -------------------------------------------------

def transducer_configs() -> dict:
    """presets.reverb_large() as a transducer: the default TransducerConfig
    (RNN predictor 2 × 256, joint 512, tanh; WeNet's conformer_rnnt
    predictor_conf/joint_conf), 0.75·rnnt + 0.25·ctc."""
    configs = presets_large()
    configs.update(model='transducer', predictor='rnn', model_conf={})
    return configs


def transducer_batch(dev, B, seed, vocab):
    """B utterances of FAM_FRAMES feature frames (zero past each length),
    16-FAM_MAX_U target tokens padded with -1, cat_embs [1, 0]."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo, hi = FAM_FRAMES
    lens = torch.randint(lo, hi + 1, (B,), device=dev, generator=gen)
    lens[0] = hi
    feats = torch.randn(B, hi, 80, device=dev, generator=gen)
    feats *= (torch.arange(hi, device=dev)[None, :]
              < lens[:, None])[..., None]
    tlens = torch.randint(16, FAM_MAX_U + 1, (B,), device=dev,
                          generator=gen)
    target = torch.randint(1, vocab - 1, (B, FAM_MAX_U), device=dev,
                           generator=gen)
    target[torch.arange(FAM_MAX_U, device=dev)[None, :]
           >= tlens[:, None]] = -1
    return {'feats': feats, 'feats_lengths': lens, 'target': target,
            'target_lengths': tlens,
            'cat_embs': torch.tensor([[1.0, 0.0]] * B, device=dev)}


def sharpen_joint(model, enc, mask) -> float:
    """Shape the random joint like a trained one, as the CTC head of
    bench.py: the output layer ×8, the blank bias raised to the 75th
    percentile of (best non-blank − blank) over the valid frames with
    the predictor's start output, so that blank wins ~75% of them."""
    import torch
    pred, joint = model.predictor, model.joint
    blank = model.tcfg.blank_id
    with torch.no_grad():
        joint.ffn_out.weight.mul_(8.0)
        p0, _ = pred.step(torch.full((1,), blank, device=enc.device),
                          pred.init_state(1, enc.device))
        logits = joint(enc[mask[:, 0]], p0).float()
        b = logits[:, blank].clone()
        logits[:, blank] = -math.inf
        q = torch.quantile(logits.amax(-1) - b, 0.75)
        joint.ffn_out.bias[blank] += q
    return float(q)


def family_transducer(dev, seed, workdir: Path, feats, audio_s) -> dict:
    """(a) reverb_large + the default RNN predictor and joint + a CTC
    head: one f32 chunk's encoder through the kernels (each K1/K5 call
    held to its plain version) and the plain versions, greedy and device
    TSD tokens equal on both; then in bf16 the 8 chunks of the 164 s file
    (K1 18, K5 91 an encoder call), the batched greedy search and the
    device TSD (beam 4) over all 8, the host searches of
    FAM_HOST_SEARCHES (beam 4) on one chunk each, timed; the RNN-T loss
    timed on the training lattice; `family_train` (f32 reference at B = 2,
    FAM_STEPS bf16 steps at B = FAM_B); `bin.train` with a checkpoint
    written and resumed."""
    import gc
    import torch
    from reverb_tpu_torch.decode.transducer_device import tsd_device_host
    from reverb_tpu_torch.decode.transducer_search import \
        beam_search_transducer
    from reverb_tpu_torch.models.registry import init_model
    from reverb_tpu_torch.models.transducer import (rnnt_loss,
                                                    transducer_greedy_device)
    bundle = init_model(transducer_configs(), torch.Generator(
        device=dev).manual_seed(seed), dev)
    model = bundle.model.requires_grad_(False)
    pred, joint = model.predictor, model.joint
    x = feats.reshape(N_CHUNKS, CHUNK, -1)
    lens = torch.full((N_CHUNKS,), CHUNK, device=dev)
    cat = torch.tensor([1.0, 0.0], device=dev)
    with torch.inference_mode():
        enc, mask = model.forward_encoder(x[:4], lens[:4], cat)
    q = sharpen_joint(model, enc, mask)
    log(f'transducer: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}'
        f'M params; joint x8, blank bias +{q:.3f} (75th percentile)')
    res = {}

    # f32 reference on one chunk
    errs = {}
    outs = {}
    for name, table in (('kernels', checked_kernels(errs)),
                        ('plain', plain_versions())):
        diar_zero_launch_counts()
        with swapped(table), torch.inference_mode():
            e, m = model.forward_encoder(x[:1], lens[:1], cat)
            e_lens = m[:, 0].sum(-1)
            outs[name] = (e, transducer_greedy_device(pred, joint, e,
                                                      e_lens),
                          tsd_device_host(pred, joint, e, e_lens,
                                          beam_size=FAM_BEAM))
        torch.cuda.synchronize()
        if name == 'kernels':
            ref_launches = diar_launch_counts()
    log_call_errs(errs, 'transducer f32 chunk')
    check_call_errs(errs, 'transducer f32 chunk', ('K1', 'K5'))
    err = float((outs['kernels'][0] - outs['plain'][0]).abs().max())
    same_greedy = torch.equal(outs['kernels'][1], outs['plain'][1])
    same_tsd = [[y for y, _ in h] for h in outs['kernels'][2]] == \
        [[y for y, _ in h] for h in outs['plain'][2]]
    n_tok = int((outs['kernels'][1] != 0).sum())
    log(f'transducer reference: f32 chunk, kernels vs plain: encoder max '
        f'abs err {err:.3e}; greedy tokens equal {same_greedy} ({n_tok} '
        f'tokens), TSD prefixes equal {same_tsd}')
    if not (err <= 1e-3 and same_greedy and same_tsd and n_tok > 0):
        raise AssertionError('transducer reference: kernels differ from the '
                             'plain versions')
    res['reference'] = {'enc_err': err, 'call_errs': errs,
                        'launches': ref_launches, 'tokens': n_tok}
    del outs

    # bf16 serving of the 8 chunks
    model.cfg = model.cfg.with_compute_dtype(torch.bfloat16)
    ln_calls, hooks = ln_call_counter(model)
    try:
        diar_zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            enc, mask = model.forward_encoder(x, lens, cat)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        launches = diar_launch_counts()
    finally:
        for h in hooks:
            h.remove()
    expect_launches(launches, {'K1': LAYERS_ENC, 'K2': 0, 'K3': 0, 'K4': 0,
                               'K5': LN_ENC, 'K6': 0},
                    'transducer encoder, 8 chunks')
    if ln_calls[0] != LN_ENC:
        raise AssertionError(f'transducer encoder: {ln_calls[0]} LayerNorm '
                             f'calls')
    e_lens = mask[:, 0].sum(-1)
    times = {'encoder_s': enc_s}
    with torch.inference_mode():
        for rep in range(2):               # a warm-up, then the timed one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = transducer_greedy_device(pred, joint, enc, e_lens)
            torch.cuda.synchronize()
            times['greedy_s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tsd = tsd_device_host(pred, joint, enc, e_lens, beam_size=FAM_BEAM)
        torch.cuda.synchronize()
        times['tsd_s'] = time.perf_counter() - t0
        found = {'greedy': int((toks != 0).sum()),
                 'tsd': sum(len(h[0][0]) for h in tsd)}
        for i, st in enumerate(FAM_HOST_SEARCHES):
            j = i % enc.shape[0]
            t0 = time.perf_counter()
            hyps = beam_search_transducer(pred, joint, enc[j:j + 1],
                                          e_lens[j:j + 1], st,
                                          beam_size=FAM_BEAM)
            times[f'{st}_s'] = time.perf_counter() - t0
            found[st] = len(hyps[0][0].tokens)
            if not math.isfinite(hyps[0][0].score):
                raise AssertionError(f'transducer {st}: score '
                                     f'{hyps[0][0].score}')
    log(f'transducer serving, bf16: encoder {enc_s:.4f} s for {audio_s:.2f} '
        f's; greedy (8 chunks) {times["greedy_s"]:.3f} s, device TSD (8 '
        f'chunks, beam {FAM_BEAM}) {times["tsd_s"]:.3f} s; one chunk each: '
        + ', '.join(f'{st} {times[st + "_s"]:.3f} s'
                    for st in FAM_HOST_SEARCHES)
        + f'; tokens of the best hypotheses {found}')
    if min(found.values()) <= 0:
        raise AssertionError(f'transducer searches emit nothing: {found}')
    res['serve'] = {'launches': launches, 'times': times, 'tokens': found}
    del enc, mask, toks, tsd, bundle, model, pred, joint
    gc.collect()
    torch.cuda.empty_cache()

    # training: f32 reference and FAM_STEPS bf16 steps
    res['train'] = family_train(
        dev, seed, transducer_configs(), 'transducer',
        {'K1', 'K4', 'K5', 'K6'}, LAYERS_ENC,
        lambda B, s, vocab: transducer_batch(dev, B, s, vocab), FAM_B,
        steps=FAM_STEPS, train_tol=True)
    # the RNN-T loss alone on the training lattice (f32, every row at
    # the longest lengths)
    T1 = ((FAM_FRAMES[1] - 1) // 2 - 1) // 2
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    logits = torch.randn(FAM_B, T1, FAM_MAX_U + 1, VOCAB, device=dev,
                         generator=g).requires_grad_(True)
    labels = torch.randint(1, VOCAB, (FAM_B, FAM_MAX_U), device=dev,
                           generator=g)
    t_lens = torch.full((FAM_B,), T1, device=dev)
    u_lens = torch.full((FAM_B,), FAM_MAX_U, device=dev)

    def loss_step():
        rnnt_loss(logits, t_lens, labels, u_lens).sum().backward()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res['rnnt'] = {'ms': cuda_time_ms(loss_step, 3),
                   'fwd_ms': cuda_time_ms(
                       lambda: rnnt_loss(logits.detach(), t_lens, labels,
                                         u_lens), 3),
                   'lattice_gb': logits.numel() * 4 / 1e9,
                   'extra_peak_gib': (torch.cuda.max_memory_allocated()
                                      - base) / 2 ** 30}
    log(f'rnnt_loss on ({FAM_B}, {T1}, {FAM_MAX_U + 1}, {VOCAB}) f32 '
        f'({res["rnnt"]["lattice_gb"]:.2f} GB a copy): forward '
        f'{res["rnnt"]["fwd_ms"]:.2f} ms, forward + backward '
        f'{res["rnnt"]["ms"]:.2f} ms, {res["rnnt"]["extra_peak_gib"]:.2f} '
        f'GiB above the lattice')
    del logits
    torch.cuda.empty_cache()
    res['bin_train'] = family_bin_train(dev, seed, workdir)
    return res


def family_bin_train(dev, seed, workdir: Path) -> dict:
    """`bin.train.main` on a transducer config (reverb_large width, 2
    encoder layers, bf16; FAM_BIN_WAVS + FAM_BIN_CV WAVs of 6-10 s with
    10-30 units each, B = 4): one epoch (2 steps and a CV), then the run
    again from its epoch_0.npz with the optimizer state (2 more steps);
    K1 = K4 = 2 and K5 = K6 = 11 a step, K1 2 and K5 11 a CV batch."""
    import gc
    import torch
    from reverb_tpu_torch.bin import train as train_bin
    rng = np.random.RandomState(seed)
    write_units(workdir / 'units.txt')
    units = [line.split()[0] for line in (workdir / 'units.txt').read_text(
        encoding='utf8').splitlines()[2:-1]]
    lists = {'train': [], 'cv': []}
    for i in range(FAM_BIN_WAVS + FAM_BIN_CV):
        part = 'train' if i < FAM_BIN_WAVS else 'cv'
        wav = workdir / f'fam{i:02d}.wav'
        write_wav(wav, int(rng.uniform(6.0, 10.0) * 16000), seed + 300 + i)
        lists[part].append(json.dumps({
            'key': f'job{i:02d}_fam{i:02d}', 'wav': str(wav),
            'txt': ' '.join(rng.choice(units, rng.randint(10, 31))),
            'style': 'verbatim'}))
    for part, lines in lists.items():
        (workdir / f'fam_{part}.list').write_text('\n'.join(lines) + '\n')
    configs = transducer_configs()
    configs['encoder_conf'] = dict(configs['encoder_conf'], num_blocks=2)
    configs['decoder_conf'] = dict(configs['decoder_conf'], num_blocks=1,
                                   r_num_blocks=1)
    configs.update({'dtype': 'bf16', 'tokenizer': 'char',
                    'tokenizer_conf': {
                        'symbol_table_path': str(workdir / 'units.txt'),
                        'split_with_space': True}})
    configs['dataset_conf'].update({
        'fbank_conf': {'num_mel_bins': 80, 'frame_length': 25,
                       'frame_shift': 10, 'dither': 0.1},
        'spec_aug': True, 'shuffle': True, 'sort': True,
        'batch_conf': {'batch_type': 'static', 'batch_size': 4}})
    cfg_path = workdir / 'fam_transducer.yaml'
    cfg_path.write_text(json.dumps(configs))
    model_dir = workdir / 'fam_exp'
    runs = []
    for ckpt in (None, model_dir / 'epoch_0.npz'):
        rec = {'step': [], 'wait': [], 'audio': [], 'eval': 0}
        diar_zero_launch_counts()
        t0 = time.perf_counter()
        with swapped(timed_bin_train(rec)):
            ex = train_bin.main(
                ['--config', str(cfg_path), '--train_data',
                 str(workdir / 'fam_train.list'), '--cv_data',
                 str(workdir / 'fam_cv.list'), '--model_dir',
                 str(model_dir), '--max_epoch', '1', '--log_interval', '1',
                 '--seed', str(seed), '--device', 'cuda']
                + (['--checkpoint', str(ckpt)] if ckpt else []))
        wall = time.perf_counter() - t0
        runs.append({'step': ex.step, 'cv_batches': rec['eval'],
                     'launches': diar_launch_counts(), 'wall_s': wall})
        del ex
        gc.collect()
        torch.cuda.empty_cache()
    info = json.loads((model_dir / 'epoch_0.yaml').read_text())
    for i, r in enumerate(runs):
        steps = r['step'] - (runs[0]['step'] if i else 0)
        n_cv = r['cv_batches']
        expect_launches(r['launches'], {
            'K1': 2 * (steps + n_cv), 'K2': 0, 'K3': 0, 'K4': 2 * steps,
            'K5': 11 * (steps + n_cv), 'K6': 11 * steps},
            f'transducer bin.train run {i} ({steps} steps, {n_cv} CV '
            f'batches, {r["wall_s"]:.1f} s)')
    if not (runs[0]['step'] == 2 and runs[1]['step'] == 4
            and info['step'] == 4 and math.isfinite(info['cv_loss'])):
        raise AssertionError(f'transducer bin.train: runs {runs}, epoch_0 '
                             f'{info}')
    return {'runs': runs, 'cv_loss': info['cv_loss']}


# ---- (c) the alternative encoders ---------------------------------------

def family_alt(dev, seed) -> dict:
    """(c) Each alternative encoder at reverb_large width (d 1024, 16
    heads, 4096 units, FAM_LAYERS layers) with a transformer decoder and
    the hybrid loss: `family_train` at the train phase's batches (K1/K4
    at the rel-pos attention layers, FAM_ALT_K1)."""
    res = {}
    for kind, extra in FAM_ALT.items():
        configs = presets_large()
        configs['encoder'] = kind
        configs['decoder'] = 'transformer'
        configs['encoder_conf'] = dict(configs['encoder_conf'],
                                       num_blocks=FAM_LAYERS, **extra)
        k1 = FAM_ALT_K1[kind]
        res[kind] = family_train(
            dev, seed, configs, kind,
            {'K1', 'K4', 'K5', 'K6'} if k1 else {'K5', 'K6'}, k1,
            lambda B, s, vocab: train_batch(dev, B, s, vocab), TRAIN_B)
    return res


def run_families(dev, seed=SEED) -> dict:
    """Phase families: (b) the MoE conformer, (a) the transducer, (c) the
    alternative encoders.  Returns their results and `total`: every
    launch the phase counted."""
    import torch
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='reverb_families_') as tmp:
        workdir = Path(tmp)
        n_samples = 400 + 160 * (N_CHUNKS * CHUNK - 1)
        wav = workdir / 'long.wav'
        write_wav(wav, n_samples, seed)
        audio_s = n_samples / 16000
        res = {'moe': family_moe(dev, seed, workdir, wav, audio_s)}
        feats = res['moe'].pop('feats')
        walls = {'moe': time.perf_counter() - t0}
        res['transducer'] = family_transducer(dev, seed, workdir, feats,
                                              audio_s)
        walls['transducer'] = time.perf_counter() - t0 - walls['moe']
        del feats
        torch.cuda.empty_cache()
        res['alt'] = family_alt(dev, seed)
        walls['alt'] = (time.perf_counter() - t0 - walls['moe']
                        - walls['transducer'])
    counted = [res['moe']['serve']['launches'],
               res['transducer']['reference']['launches'],
               res['transducer']['serve']['launches'],
               *(r['launches'] for r in res['transducer']['bin_train'][
                   'runs'])]
    trains = [res['moe']['train'], res['transducer']['train'],
              *res['alt'].values()]
    total = {}
    for d in counted + [t['reference']['launches'] for t in trains]:
        for n, v in d.items():
            total[n] = total.get(n, 0) + v
    for t in trains:
        for n, v in t['launches'].items():
            total[n] = total.get(n, 0) + v * t['steps']
    res['total'] = total
    res['wall_s'] = time.perf_counter() - t0
    res['walls'] = walls
    log(f'families: {res["wall_s"]:.1f} s ('
        + ', '.join(f'{n} {w:.1f} s' for n, w in walls.items())
        + f'); launches {total}')
    return res


# ------------------------------ phase 21: Paraformer and the transformer --

PARA_VOCAB = 8404              # SanmConfig(): Ali-Paraformer-large
PARA_AUDIO_S = 60.0            # the serving WAV
PARA_ALPHA = 0.25              # the CIF head's mean α a frame (~4 tokens/s)
# K5 a forward at SanmConfig(): encoders0's norm2 (its norm1 spans the
# 560 LFR channels: plain) + 49 × 2 + after_norm; 16 decoder layers × 4
# (norm1-3 and the FFN's norm over 2048) + decoders3's 2 + after_norm
PARA_LN_ENC, PARA_LN_DEC = 100, 67
# Paraformer-large V3's predictor (cif_conf of its WeNet-converted config)
PARA_CIF = {'l_order': 1, 'r_order': 1, 'cnn_groups': 1, 'residual': False,
            'threshold': 1.0, 'tail_threshold': 0.45, 'smooth_factor2': 0.25,
            'noise_threshold2': 0.01, 'upsample_times': 3}
# a training step scales α to sum to the target length, so the last fire
# comes with the integrator at 1.0 give or take an ulp; the f32 reference
# checks fire at 0.999, 1e-3 clear of that, so kernels and plain versions
# fire alike (tests/test_torch_paraformer.py does the same)
PARA_REF_THRESHOLD = 0.999
PARA_BIN_WAVS, PARA_BIN_CV = 24, 2       # bin.train: 3 steps of B = 8
PARA_LAYERS = 6                # the conformer Paraformer, the transformer


def para_configs() -> dict:
    """The SANM Paraformer at SanmConfig()'s widths (LFR 7/6 → 560 → 512,
    4 heads, 2048 units, 50 + 16 blocks, kernel 11, V 8404), the V3 CIF
    predictor, the glancing sampler on, f32."""
    return {'model': 'paraformer', 'encoder': 'sanm_encoder',
            'input_dim': 80, 'output_dim': PARA_VOCAB,
            'encoder_conf': {'output_size': 512, 'attention_heads': 4,
                             'linear_units': 2048, 'num_blocks': 50,
                             'kernel_size': 11, 'sanm_shfit': 0,
                             'dropout_rate': 0.1},
            'decoder_conf': {'num_blocks': 16},
            'lfr_conf': {'lfr_m': 7, 'lfr_n': 6},
            'cif_conf': dict(PARA_CIF),
            'model_conf': {'ctc_weight': 0.0, 'sampler': True,
                           'sampling_ratio': 0.75, 'lsm_weight': 0.1},
            'optim': 'adam', 'optim_conf': {'lr': 1e-3},
            'scheduler': 'warmuplr', 'scheduler_conf': {'warmup_steps': 25000},
            'grad_clip': 5.0, 'accum_grad': 1}


def write_para_units(path: Path) -> list:
    """An 8404-entry units.txt: 4 specials, 8000 CJK characters, 200
    '@@' pieces and 200 word ends; returns the units."""
    units = (['<blank>', '<s>', '</s>', '<unk>']
             + [chr(0x4e00 + i) for i in range(8000)]
             + [f'x{i}@@' for i in range(200)] + [f'x{i}' for i in range(200)])
    path.write_text(''.join(f'{u} {i}\n' for i, u in enumerate(units)),
                    encoding='utf8')
    return units


def set_cif_rate(model, feats, lens, alpha) -> float:
    """Set the CIF output bias (by bisection) so that α averages `alpha` a
    valid frame of (feats, lens): a random head may fire nothing.  Returns
    the bias."""
    import torch
    from reverb_tpu_torch.models.paraformer import cif_alphas
    bias = model.predictor.cif_output.bias
    with torch.no_grad():
        enc, mask = model.encoder(feats, lens)
        lo, hi = -30.0, 30.0
        for _ in range(40):
            bias.fill_((lo + hi) / 2)
            mean = float(cif_alphas(model.predictor, enc, mask)[
                mask[:, 0]].mean())
            lo, hi = ((lo + hi) / 2, hi) if mean < alpha else \
                (lo, (lo + hi) / 2)
    return float(bias.detach())


def para_result_check(res: dict, what: str):
    """A `transcribe --paraformer -t` result: text, tokens with finite,
    ordered times and confidences in (0, 1]."""
    toks = res.get('tokens') or []
    ok = res['text'] and len(toks) >= 30 and 0 < res['confidence'] <= 1
    for a, b in zip(toks, toks[1:] + [None]):
        ok = ok and 0 <= a['start'] <= a['end'] and \
            0 < a['confidence'] <= 1 and (b is None or a['start']
                                          <= b['start'])
    if not ok:
        raise AssertionError(f'{what}: result {res}')


def para_same(got: dict, want: dict) -> float:
    """Raise unless two results have the same text and tokens, times
    exactly, confidences within 1e-5; returns the worst confidence
    difference."""
    worst = abs(got['confidence'] - want['confidence'])
    same = got['text'] == want['text'] and \
        len(got['tokens']) == len(want['tokens'])
    for g, w in zip(got['tokens'], want['tokens']):
        same = same and (g['token'], g['start'], g['end']) == \
            (w['token'], w['start'], w['end'])
        worst = max(worst, abs(g['confidence'] - w['confidence']))
    if not (same and worst <= 1e-5):
        raise AssertionError(f'paraformer: the result through the plain '
                             f'versions differs (confidence {worst:.2e})')
    return worst


def para_serve(dev, seed, workdir: Path) -> dict:
    """The SANM Paraformer at full width with the tp branch, random weights
    from `seed`, its CIF bias set for PARA_ALPHA on the WAV's features,
    saved as a model directory (config.yaml, units.txt, final.pt); then
    `cli/transcribe.main([wav, '-m', dir, '--paraformer', '-t'])` on a 60 s
    WAV: a first call with every K5 call held to its plain version, a
    second call timed (the CLI's wall with its model load, transcribe()
    alone), each launching K5 PARA_LN_ENC + PARA_LN_DEC times and nothing
    else; then the same call with the plain versions: text, tokens and
    times equal, confidences within 1e-5; then the call once more under
    torch.profiler, read by its spans (para_phases)."""
    import contextlib
    import gc
    import io
    import torch
    from reverb_tpu_torch.cli import paraformer_model as pm
    from reverb_tpu_torch.cli import transcribe
    from reverb_tpu_torch.frontend.audio import load_for_asr
    from reverb_tpu_torch.frontend.fbank import (FbankConfig, compute_fbank,
                                                 num_frames)
    from reverb_tpu_torch.models import registry
    from reverb_tpu_torch.models.paraformer import SanmParaformer
    configs = para_configs()
    scfg, cif = registry.sanm_configs(configs)
    t0 = time.perf_counter()
    model = registry._materialise(
        lambda: SanmParaformer(scfg, cif, with_tp=True), dev,
        torch.Generator(device=dev).manual_seed(seed), None).eval()
    n_params = sum(p.numel() for p in model.parameters())
    wav = workdir / 'para60.wav'
    write_wav(wav, int(PARA_AUDIO_S * 16000), seed + 400)
    wave = load_for_asr(str(wav), 16000)
    fb = FbankConfig()
    T = num_frames(len(wave), fb)
    feats = compute_fbank(torch.from_numpy(wave).to(dev), fb, n_frames=T)
    bias = set_cif_rate(model, feats[None], torch.tensor([T], device=dev),
                        PARA_ALPHA)
    mdir = workdir / 'paraformer'
    mdir.mkdir()
    (mdir / 'config.yaml').write_text(json.dumps(configs))
    write_para_units(mdir / 'units.txt')
    torch.save(model.state_dict(), mdir / 'final.pt')
    build_s = time.perf_counter() - t0
    del model, feats
    gc.collect()
    torch.cuda.empty_cache()
    log(f'paraformer: SANM {n_params / 1e6:.1f}M params (f32, tp branch), '
        f'CIF bias {bias:.3f} for mean alpha {PARA_ALPHA}; model directory '
        f'written in {build_s:.1f} s')
    orig = pm.Paraformer.transcribe
    inner = {}

    def timed(self, *a, **k):
        calls, hooks = ln_call_counter(self.model)
        try:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = orig(self, *a, **k)
            torch.cuda.synchronize()
            inner.update(s=time.perf_counter() - t1, ln=calls[0])
        finally:
            for h in hooks:
                h.remove()
        return out
    argv = [str(wav), '-m', str(mdir), '--paraformer', '-t', '--device',
            'cuda']
    runs, errs = [], {}
    for name, table in (('checked', checked_kernels(errs)),
                        ('timed', {}), ('plain', plain_versions()),
                        ('traced', {})):
        diar_zero_launch_counts()
        prof = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
            if name == 'traced' else contextlib.nullcontext())
        t1 = time.perf_counter()
        with swapped({(pm.Paraformer, 'transcribe'): timed, **table}), \
                contextlib.redirect_stdout(io.StringIO()) as out, prof:
            res = transcribe.main(argv)
        wall = time.perf_counter() - t1
        if json.loads(out.getvalue().splitlines()[-1]) != json.loads(
                json.dumps(res, ensure_ascii=False)):
            raise AssertionError('paraformer: the CLI printed another result')
        runs.append({'name': name, 'wall_s': wall, 'res': res,
                     'launches': diar_launch_counts(), **inner})
        gc.collect()
        torch.cuda.empty_cache()
    log_call_errs(errs, 'paraformer serving, every K5 call')
    check_call_errs(errs, 'paraformer serving', ('K5',))
    n_ln = PARA_LN_ENC + PARA_LN_DEC
    for r in runs[:2]:
        expect_launches(r['launches'], {'K1': 0, 'K2': 0, 'K3': 0, 'K4': 0,
                                        'K5': n_ln, 'K6': 0},
                        f'paraformer serving, {r["name"]} call')
        if r['ln'] != n_ln:
            raise AssertionError(f'paraformer serving: {r["ln"]} LayerNorm '
                                 f'calls K5 takes, expected {n_ln}')
        para_result_check(r['res'], f'paraformer {r["name"]} call')
    if runs[2]['launches']['K5'] != 0:
        raise AssertionError('paraformer: the plain run launched K5')
    worst = para_same(runs[1]['res'], runs[2]['res'])
    para_same(runs[0]['res'], runs[1]['res'])
    para_same(runs[3]['res'], runs[1]['res'])
    phases = para_phases(prof, workdir / 'para_trace.json')
    t = runs[1]
    n_tok = len(t['res']['tokens'])
    log(f'paraformer serving ({PARA_AUDIO_S:.0f} s, {n_tok} tokens): '
        f'second CLI call {t["wall_s"]:.3f} s with the model load, '
        f'transcribe() {t["s"] * 1e3:.1f} ms (xRT '
        f'{PARA_AUDIO_S / t["s"]:.1f}); K5 {t["launches"]["K5"]} a call; '
        f'the plain versions give the same text, tokens and times '
        f'(confidences within {worst:.1e}); first call {runs[0]["s"]:.3f} s')
    log('paraformer serving, traced call by span (host ms / device ms): '
        + ', '.join(f'{k} {h:.1f} / ' + ('not measured' if d is None
                                          else f'{d:.1f}')
                    for k, (h, d) in phases.items()))
    return {'params': n_params, 'tokens': n_tok, 'calls': runs[:2],
            'walls': [r['wall_s'] for r in runs],
            'transcribe_s': [r['s'] for r in runs],
            'phases': phases, 'launches': t['launches'],
            'total': {n: runs[0]['launches'][n] + runs[1]['launches'][n]
                      for n in runs[1]['launches']}, 'conf_err': worst,
            'call_errs': errs}


def para_phases(prof, path: Path) -> dict:
    """{phase: (host ms, device ms)} of the `paraformer.*` spans
    (utils/profiling.py:span) in a profiled transcribe: each span's own
    length on the host, and the device time of the kernels and copies
    whose host launch lies inside it (None where the trace holds no
    device event, as the profiler has returned on the H100).  It raises
    where a span is missing."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    path.unlink()
    events = events['traceEvents'] if isinstance(events, dict) else events
    spans, launch, device = {}, {}, []
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat, args = e.get('cat', ''), e.get('args') or {}
        ts, end = float(e['ts']), float(e['ts']) + float(e.get('dur', 0))
        if e['name'].startswith('span:paraformer.'):
            spans[e['name'][16:]] = (ts, end)
        elif cat in ('cuda_runtime', 'cuda_driver') and 'correlation' in args:
            launch[args['correlation']] = ts
        elif cat in ('kernel', 'gpu_memcpy', 'gpu_memset'):
            device.append((end - ts, args.get('correlation')))
    names = ('encoder', 'cif', 'decoder', 'search')
    if set(spans) != set(names):
        raise AssertionError(f'paraformer: the traced call has the spans '
                             f'{sorted(spans)}')
    out = {}
    for n in names:
        s, e = spans[n]
        out[n] = ((e - s) / 1e3, sum(
            us for us, corr in device
            if corr in launch and s <= launch[corr] <= e) / 1e3
            if device else None)
    return out


def para_reference(dev, seed, configs, what, kernels) -> dict:
    """`family_reference` of a registry model built from `configs` in
    f32 at B = 2 of the train phase's batches."""
    import gc
    import torch
    from reverb_tpu_torch.models.registry import init_model
    bundle = init_model(dict(configs, dtype='fp32'), torch.Generator(
        device=dev).manual_seed(seed), dev)
    ref = family_reference(bundle.model, bundle.loss_fn,
                           train_batch(dev, 2, seed + 1, PARA_VOCAB), dev,
                           kernels, what)
    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def para_bin_train(dev, seed, workdir: Path) -> dict:
    """`bin.train.main` on the SANM Paraformer at full depth in bf16 (f32
    master weights): PARA_BIN_WAVS WAVs of 16-20.5 s (1600-2051 frames)
    with 40-80 units each, static batches of 8, a CV of PARA_BIN_CV, one
    epoch; the step and the dataset iterator timed (steps 2 on), peak
    memory; K5 = PARA_LN_ENC + 2 · PARA_LN_DEC a step and a CV batch (the
    sampler's frozen decoder pass, then the decoder), K6 = PARA_LN_ENC +
    PARA_LN_DEC a step."""
    import gc
    import torch
    from reverb_tpu_torch.bin import train as train_bin
    rng = np.random.RandomState(seed)
    units_path = workdir / 'para_units.txt'
    cjk = write_para_units(units_path)[4:8004]
    lists = {'train': [], 'cv': []}
    for i in range(PARA_BIN_WAVS + PARA_BIN_CV):
        part = 'train' if i < PARA_BIN_WAVS else 'cv'
        wav = workdir / f'para{i:02d}.wav'
        write_wav(wav, int(rng.uniform(16.0, 20.5) * 16000), seed + 500 + i)
        lists[part].append(json.dumps({
            'key': f'p{i:02d}', 'wav': str(wav),
            'txt': ' '.join(rng.choice(cjk, rng.randint(40, 81)))}))
    for part, lines in lists.items():
        (workdir / f'para_{part}.list').write_text('\n'.join(lines) + '\n')
    configs = para_configs()
    configs.update({
        'dtype': 'bf16', 'tokenizer': 'char',
        'tokenizer_conf': {'symbol_table_path': str(units_path),
                           'split_with_space': True},
        'dataset_conf': {
            'fbank_conf': {'num_mel_bins': 80, 'frame_length': 25,
                           'frame_shift': 10, 'dither': 0.1},
            'spec_aug': True, 'shuffle': True, 'sort': True,
            'batch_conf': {'batch_type': 'static', 'batch_size': 8},
            'num_workers': 4}})
    configs.pop('output_dim')
    cfg_path = workdir / 'para_train.yaml'
    cfg_path.write_text(json.dumps(configs))
    rec = {'step': [], 'wait': [], 'audio': [], 'eval': 0}
    diar_zero_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with swapped(timed_bin_train(rec)):
        ex = train_bin.main([
            '--config', str(cfg_path), '--train_data',
            str(workdir / 'para_train.list'), '--cv_data',
            str(workdir / 'para_cv.list'), '--model_dir',
            str(workdir / 'para_exp'), '--max_epoch', '1',
            '--log_interval', '1', '--seed', str(seed), '--device', 'cuda'])
    wall = time.perf_counter() - t0
    launches = diar_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps, n_eval = ex.step, rec['eval']
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    per5 = PARA_LN_ENC + 2 * PARA_LN_DEC
    expect_launches(launches, {
        'K1': 0, 'K2': 0, 'K3': 0, 'K4': 0, 'K5': per5 * (steps + n_eval),
        'K6': (PARA_LN_ENC + PARA_LN_DEC) * steps},
        f'paraformer bin.train ({steps} steps, {n_eval} CV batches)')
    info = json.loads((workdir / 'para_exp' / 'epoch_0.yaml').read_text())
    metrics = [json.loads(x) for x in (workdir / 'para_exp'
                                       / 'metrics.jsonl').read_text()
               .splitlines()]
    if steps != PARA_BIN_WAVS // 8 or not math.isfinite(info['cv_loss']) \
            or not all(math.isfinite(m['train/loss']) for m in metrics):
        raise AssertionError(f'paraformer bin.train: {steps} steps, '
                             f'epoch_0 {info}, metrics {metrics}')
    n = len(rec['step'])
    step_ms = sum(rec['step'][1:]) / (n - 1) * 1e3
    wait_ms = sum(rec['wait'][1:n]) / (n - 1) * 1e3
    audio = sum(rec['audio'][1:]) / (n - 1)
    res = {'steps': steps, 'cv_batches': n_eval, 'launches': launches,
           'step_ms': step_ms, 'wait_ms': wait_ms,
           'first_step_ms': rec['step'][0] * 1e3, 'audio_s_per_step': audio,
           'audio_s_per_s': audio / (step_ms + wait_ms) * 1e3,
           'peak_gib': peak / 2 ** 30, 'wall_s': wall,
           'cv_loss': info['cv_loss'],
           'losses': [m['train/loss'] for m in metrics]}
    log(f'paraformer bin.train (SANM, bf16, B = 8): {wall:.1f} s in all; '
        f'steps 2-{n}: {step_ms:.1f} ms a step, {wait_ms:.2f} ms a step '
        f'waiting on the dataset ({audio:.1f} s of audio a step: '
        f'{res["audio_s_per_s"]:.1f} audio-s/s); first step '
        f'{res["first_step_ms"]:.1f} ms; peak {res["peak_gib"]:.2f} GiB; '
        f'losses {[round(x, 3) for x in res["losses"]]}, cv_loss '
        f'{info["cv_loss"]:.4f}')
    return res


def para_conformer_configs() -> dict:
    """reverb_large at PARA_LAYERS layers with the CIF head (no LSL: the
    Paraformer loss passes no cat_embs), firing at PARA_REF_THRESHOLD."""
    configs = presets_large()
    configs['model'] = 'paraformer'
    configs['encoder_conf'] = dict(configs['encoder_conf'],
                                   num_blocks=PARA_LAYERS)
    configs['dataset_conf'] = dict(configs['dataset_conf'],
                                   pass_cat_emb=False)
    configs['paraformer_conf'] = {'cif_conf': {
        'threshold': PARA_REF_THRESHOLD}}
    return configs


def transformer_configs() -> dict:
    """reverb_large with a transformer encoder (abs_pos, plain MHA) at
    PARA_LAYERS layers."""
    configs = presets_large()
    configs['encoder'] = 'transformer'
    configs['encoder_conf'] = dict(
        configs['encoder_conf'], num_blocks=PARA_LAYERS,
        pos_enc_layer_type='abs_pos', selfattention_layer_type='selfattn')
    return configs


def transformer_serve(dev, seed, workdir: Path) -> dict:
    """The transformer-encoder asr_model (bf16, a sharpened CTC head) on
    the 60 s WAV: a warm-up and a timed transcribe_modes(MODES, 'ctm')
    call, K1 never, K2 = K3 = 1 an encoder call, K5 at every LayerNorm."""
    import gc
    import torch
    from reverb_tpu_torch.cli import reverb as rv
    from reverb_tpu_torch.cli.reverb import ReverbASR
    from reverb_tpu_torch.models.asr_model import ModelConfig, build_model
    from reverb_tpu_torch.text.tokenizer import init_tokenizer
    configs = transformer_configs()
    configs['tokenizer'] = 'char'
    configs['tokenizer_conf'] = {
        'symbol_table_path': str(workdir / 'units.txt')}
    write_units(workdir / 'units.txt')
    cfg = ModelConfig.from_config(configs).with_compute_dtype(torch.bfloat16)
    model = build_model(cfg, dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    asr = ReverbASR.from_model(configs, model, init_tokenizer(configs))
    wav = workdir / 'para60.wav'
    feats = asr.compute_feats(str(wav))
    q = sharpen_ctc_head(asr, feats)
    decode_fn = rv.decode_modes_fn
    n_enc = [0]

    def counted_decode(*args, **kwargs):
        n_enc[0] += 1
        return decode_fn(*args, **kwargs)
    ln_calls, hooks = ln_call_counter(asr.model)
    walls, ctms, per_call = [], [], []
    try:
        rv.decode_modes_fn = counted_decode
        for i in range(2):
            n_enc[0] = ln_calls[0] = 0
            diar_zero_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ctms.append(asr.transcribe_modes(str(wav), MODES, format='ctm'))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            per_call.append(diar_launch_counts())
            expect_launches(per_call[-1], {
                'K1': 0, 'K2': n_enc[0], 'K3': n_enc[0], 'K4': 0,
                'K5': ln_calls[0], 'K6': 0},
                f'transformer serving, call {i + 1} ({n_enc[0]} encoder '
                f'calls)')
    finally:
        rv.decode_modes_fn = decode_fn
        for h in hooks:
            h.remove()
    launches = per_call[1]
    rows = [check_ctm_rows(c, wav.name, f'transformer {m}')
            for m, c in zip(MODES, ctms[1])]
    if min(rows) <= 0:
        raise AssertionError(f'transformer serving: CTM rows {rows}')
    log(f'transformer asr_model ({PARA_LAYERS} layers, bf16) serving '
        f'{PARA_AUDIO_S:.0f} s: second call {walls[1]:.4f} s (first '
        f'{walls[0]:.4f} s); ctc head blank bias +{q:.3f}; CTM rows '
        f'{rows}; K5 {ln_calls[0]} a call')
    del asr, model
    gc.collect()
    torch.cuda.empty_cache()
    return {'walls': walls, 'launches': launches, 'encoder_calls': n_enc[0],
            'total': {n: sum(c[n] for c in per_call) for n in launches}}


def cif_loop_times(dev, seed) -> dict:
    """The CIF frame loop alone (`cif_fire`, f32 state) at the training
    shapes: B = 8 rows of 343 SANM frames (d 512, U 80) and of 512
    conformer frames (d 1024), bf16 frames; ms of the forward and of the
    forward + backward (CUDA events around back-to-back calls, the host's
    launches included)."""
    import torch
    from reverb_tpu_torch.models.paraformer import cif_fire
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, T, D in (('sanm', 343, 512), ('conformer', 512, 1024)):
        h = torch.randn(8, T, D, device=dev, generator=g).to(
            torch.bfloat16).requires_grad_(True)
        a = (torch.rand(8, T, device=dev, generator=g) * 0.4).requires_grad_(
            True)

        def fwd():
            with torch.no_grad():
                cif_fire(h, a, 80)

        def fwd_bwd():
            emb, _ = cif_fire(h, a, 80)
            emb.sum().backward()
        out[name] = {'T': T, 'fwd_ms': cuda_time_ms(fwd, 3),
                     'fwd_bwd_ms': cuda_time_ms(fwd_bwd, 3)}
    log('CIF loop alone, B = 8, U = 80: ' + '; '.join(
        f'{n} T={r["T"]}: forward {r["fwd_ms"]:.1f} ms, forward + backward '
        f'{r["fwd_bwd_ms"]:.1f} ms' for n, r in out.items()))
    return out


def run_paraformer(dev, seed=SEED) -> dict:
    """Phase paraformer: the SANM Paraformer's serving through
    `transcribe --paraformer -t` and its f32 reference step at full depth
    and bin.train in bf16; the conformer-encoder Paraformer and a
    transformer-encoder asr_model at reverb_large width and PARA_LAYERS
    layers (`family_train`: the f32 reference, then timed bf16 steps at
    B = 8); the transformer's serving call.  Returns the results and
    `total`: every launch the phase counted."""
    import torch
    t0 = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory(prefix='reverb_paraformer_') as tmp:
        workdir = Path(tmp)
        res['serve'] = para_serve(dev, seed, workdir)
        sanm_ref = para_configs()
        sanm_ref['cif_conf']['threshold'] = PARA_REF_THRESHOLD
        res['sanm_reference'] = para_reference(
            dev, seed, sanm_ref, 'paraformer SANM reference', ('K5', 'K6'))
        res['bin_train'] = para_bin_train(dev, seed, workdir)
        res['cif_loop'] = cif_loop_times(dev, seed)
        res['conformer'] = family_train(
            dev, seed, para_conformer_configs(), 'paraformer conformer',
            {'K1', 'K4', 'K5', 'K6'}, PARA_LAYERS,
            lambda B, s, vocab: train_batch(dev, B, s, vocab), TRAIN_B)
        res['transformer'] = family_train(
            dev, seed, transformer_configs(), 'transformer asr_model',
            {'K5', 'K6'}, 0,
            lambda B, s, vocab: train_batch(dev, B, s, vocab), TRAIN_B)
        res['transformer_serve'] = transformer_serve(dev, seed, workdir)
    total = {}
    counted = [res['serve']['total'], res['sanm_reference']['launches'],
               res['bin_train']['launches'],
               res['transformer_serve']['total']]
    for t in (res['conformer'], res['transformer']):
        counted.append(t['reference']['launches'])
        counted.append({n: v * t['steps'] for n, v in t['launches'].items()})
    for d in counted:
        for n, v in d.items():
            total[n] = total.get(n, 0) + v
    res['total'] = total
    res['wall_s'] = time.perf_counter() - t0
    log(f'paraformer phase: {res["wall_s"]:.1f} s; launches {total}')
    torch.cuda.empty_cache()
    return res


# ------------------------------ phase 22: Whisper -------------------------

# openai/whisper-large-v3's published widths (its config.json): 1.55B
# parameters, f32 as the JAX package computes
WHISPER_CONF = {'n_mels': 128, 'n_audio_ctx': 1500, 'n_audio_state': 1280,
                'n_audio_head': 20, 'n_audio_layer': 32, 'n_vocab': 51866,
                'n_text_ctx': 448, 'n_text_state': 1280, 'n_text_head': 20,
                'n_text_layer': 32}
# <|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|>; and
# <|endoftext|>, in large-v3's vocabulary
WHISPER_SOT = (50258, 50259, 50360, 50364)
WHISPER_EOT = 50257
WHISPER_WAVS, WHISPER_AUDIO_S, WHISPER_MAX_LEN = 4, 30.0, 64
WHISPER_TRAIN_B, WHISPER_TRAIN_U, WHISPER_STEPS = 4, 64, 2
WHISPER_PEAK_GIB = 70.0      # above this peak the step runs at B = 2
# K5 an encoder call (2 a block and ln_post) and a decoded position (3 a
# block and ln)
WHISPER_LN_ENC = 2 * 32 + 1
WHISPER_LN_DEC = 3 * 32 + 1
WHISPER_MARGIN = 1e-3        # logit gap under which two runs may differ


def whisper_mels(workdir: Path, seed: int, dev):
    """WHISPER_WAVS `speech_like` WAVs of 30 s, read back and turned into
    128-bin log-mels by the port's data/processor.py
    (`compute_log_mel_spectrogram`): (B, 3000, 128) on the card."""
    import torch
    from reverb_tpu_torch.data.processor import compute_log_mel_spectrogram
    from reverb_tpu_torch.frontend.audio import load_for_asr
    mels = []
    n = int(WHISPER_AUDIO_S * 16000)
    for i in range(WHISPER_WAVS):
        path = workdir / f'whisper_{i}.wav'
        write_wav(path, n, seed + 100 + i)
        wave_ = load_for_asr(str(path)) / 32768.0      # [-1, 1], as Whisper
        mels.append(compute_log_mel_spectrogram(
            {'wav': wave_[None], 'sample_rate': 16000},
            num_mel_bins=WHISPER_CONF['n_mels'])['feat'])
    mel = torch.from_numpy(np.stack(mels)).to(dev)
    if tuple(mel.shape) != (WHISPER_WAVS, 3000, WHISPER_CONF['n_mels']) \
            or not torch.isfinite(mel).all():
        raise AssertionError(f'log-mel: shape {tuple(mel.shape)}')
    return mel


def greedy_with_margins(model, mel, sot, eot, max_len):
    """`whisper_greedy_decode`'s loop, also returning each row's logit gap
    between its best and second token at every step: (tokens after the
    prompt (B, L), gaps (B, L), inf after a row ended; numpy)."""
    import torch
    with torch.no_grad():
        feats = model.encoder(mel)
        B = mel.shape[0]
        L0 = len(sot)
        total = min(L0 + max_len, model.cfg.n_text_ctx)
        tokens = torch.full((B, total), eot, dtype=torch.int64,
                            device=mel.device)
        tokens[:, :L0] = torch.as_tensor(list(sot), device=mel.device)
        gaps = torch.full((B, total), math.inf, device=mel.device)
        finished = torch.zeros((B,), dtype=torch.bool, device=mel.device)
        for cur in range(L0, total):
            logits = model.decoder.head(
                model.decoder.hidden(tokens[:, :cur], feats)[:, -1])
            top2 = logits.topk(2, -1).values
            gaps[:, cur] = torch.where(finished, math.inf,
                                       top2[:, 0] - top2[:, 1])
            nxt = torch.where(finished, eot, logits.argmax(-1))
            tokens[:, cur] = nxt
            finished |= nxt == eot
            if bool(finished.all()):
                break
    return tokens[:, L0:].cpu().numpy(), gaps[:, L0:].cpu().numpy()


def same_until_near_tie(got, want, gaps, what) -> int:
    """Raise unless each row's tokens are equal up to its first step whose
    gap is under WHISPER_MARGIN (after which either run may go its way).
    Returns the number of tokens compared."""
    n = 0
    for b in range(got.shape[0]):
        near = np.nonzero(gaps[b] < WHISPER_MARGIN)[0]
        upto = int(near[0]) + 1 if len(near) else got.shape[1]
        if not np.array_equal(got[b, :upto], want[b, :upto]):
            raise AssertionError(f'{what}: row {b} tokens differ before a '
                                 f'near-tie: {got[b, :upto]} vs '
                                 f'{want[b, :upto]}')
        n += upto
    return n


def decoded_steps(tokens) -> int:
    """Decoded positions of a greedy call: until every row has its eot (or
    the buffer is full)."""
    steps = 0
    for row in tokens:
        hit = np.nonzero(row == WHISPER_EOT)[0]
        steps = max(steps, int(hit[0]) + 1 if len(hit) else len(row))
    return steps


def whisper_serve(dev, model, mel) -> dict:
    """Greedy decoding of the 4 × 30 s batch: a warm-up call with every K5
    call held to its plain version, then a timed call (wall, the encoder
    alone, ms a token, peak; launches K5 = 65 + 97 a decoded position),
    and the same decode through the plain LayerNorm: tokens equal up to
    the first near-tie."""
    import torch
    from reverb_tpu_torch.models.whisper import whisper_greedy_decode
    errs = {}
    with swapped(checked_kernels(errs)):
        first = whisper_greedy_decode(model, mel, WHISPER_SOT, WHISPER_EOT,
                                      WHISPER_MAX_LEN)
    log_call_errs(errs, 'whisper serving')
    check_call_errs(errs, 'whisper serving', ('K5',))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.perf_counter()
        model.encoder(mel)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
    diar_zero_launch_counts()
    t0 = time.perf_counter()
    tokens = whisper_greedy_decode(model, mel, WHISPER_SOT, WHISPER_EOT,
                                   WHISPER_MAX_LEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = diar_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = decoded_steps(tokens)
    expect_launches(launches, {'K1': 0, 'K2': 0, 'K3': 0, 'K4': 0,
                               'K5': WHISPER_LN_ENC + WHISPER_LN_DEC * steps,
                               'K6': 0}, 'whisper serving, timed call')
    if not np.array_equal(tokens, first):
        raise AssertionError('whisper serving: two calls decode differently')
    with swapped(plain_versions()):
        plain, gaps = greedy_with_margins(model, mel, WHISPER_SOT,
                                          WHISPER_EOT, WHISPER_MAX_LEN)
    compared = same_until_near_tie(tokens, plain, gaps, 'whisper serving')
    res = {'wall_s': wall, 'encoder_ms': enc_s * 1e3, 'steps': steps,
           'ms_per_token': (wall - enc_s) * 1e3 / max(steps, 1),
           'peak_gib': peak / 2 ** 30, 'launches': launches,
           'call_errs': errs, 'tokens_compared': compared,
           'min_gap': float(np.min(gaps)),
           'distinct_tokens': int(len(np.unique(tokens)))}
    log(f'whisper serving ({WHISPER_WAVS} x {WHISPER_AUDIO_S:.0f} s, sot '
        f'prefix {len(WHISPER_SOT)}, max_len {WHISPER_MAX_LEN}): '
        f'{wall:.3f} s a call, encoder {res["encoder_ms"]:.1f} ms, {steps} '
        f'positions at {res["ms_per_token"]:.2f} ms each, peak '
        f'{res["peak_gib"]:.2f} GiB; {res["distinct_tokens"]} distinct '
        f'tokens; {compared} tokens equal through the plain LayerNorm '
        f'(smallest logit gap {res["min_gap"]:.3g})')
    return res


def whisper_batch(dev, B, seed, mel):
    """B of the log-mels and targets of the prompt, 40-64 random text
    tokens and eot, padded with -1 (the bundle's `target` route)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    U = WHISPER_TRAIN_U
    lens = torch.randint(U * 5 // 8, U + 1, (B,), device=dev, generator=gen)
    lens[0] = U
    body = torch.randint(0, WHISPER_EOT, (B, U), device=dev, generator=gen)
    target = torch.cat([torch.tensor(WHISPER_SOT, device=dev)[None].expand(
        B, -1), body], 1)
    L = len(WHISPER_SOT) + lens
    target[torch.arange(target.shape[1], device=dev)[None, :]
           >= L[:, None]] = -1
    target[torch.arange(B, device=dev), L - 1] = WHISPER_EOT
    return {'feats': mel[:B].contiguous(),
            'feats_lengths': torch.full((B,), mel.shape[1], device=dev),
            'target': target, 'target_lengths': L}


def whisper_train(dev, seed, model, mel) -> dict:
    """The bundle's loss (the `target` route): one f32 loss + backward at
    B = 1 with every K5/K6 call held to its plain version, against the
    plain versions' loss and gradient; then WHISPER_STEPS timed Adam
    steps at B = 4 (B = 2 where B = 4 runs out of memory or peaks above
    WHISPER_PEAK_GIB), K5 = K6 = the LayerNorm calls a step."""
    import torch
    from reverb_tpu_torch.models.registry import whisper_loss
    model.train().requires_grad_(True)
    ref = whisper_batch(dev, 1, seed + 1, mel)
    errs = {}
    diar_zero_launch_counts()
    loss_k, g_k = loss_and_grads(model, ref, dev, checked_kernels(errs),
                                 whisper_loss)
    ref_launches = diar_launch_counts()
    loss_p, g_p = loss_and_grads(model, ref, dev, plain_versions(),
                                 whisper_loss)
    log_call_errs(errs, 'whisper reference')
    check_call_errs(errs, 'whisper reference', ('K5', 'K6'))
    rel = abs(loss_k - loss_p) / abs(loss_p)
    dist = grad_dist(g_k, g_p)
    del g_k, g_p
    log(f'whisper reference (f32, B = 1): loss {loss_k:.6f} vs plain '
        f'{loss_p:.6f} (rel {rel:.2e}); gradient distance {dist:.2e}')
    if rel > 1e-5 or dist > 1e-3:
        raise AssertionError('whisper reference: kernels differ from the '
                             'plain versions')
    gc.collect()
    torch.cuda.empty_cache()
    res, notes = None, []
    for B in (WHISPER_TRAIN_B, 2):
        try:
            res = family_steps(model, whisper_loss,
                               whisper_batch(dev, B, seed + 2, mel), dev,
                               seed + 3, WHISPER_STEPS,
                               f'whisper-large-v3 step at B={B}')
        except torch.cuda.OutOfMemoryError:
            notes.append(f'B={B} ran out of memory')
            res = None
        gc.collect()
        torch.cuda.empty_cache()
        if res is not None and res['peak_gib'] <= WHISPER_PEAK_GIB:
            break
        if res is not None:
            notes.append(f'B={B} peaked at {res["peak_gib"]:.2f} GiB')
    if res is None:
        raise AssertionError(f'whisper step: {notes}')
    expect_launches(res['launches'], {
        'K1': 0, 'K2': 0, 'K3': 0, 'K4': 0, 'K5': res['ln_calls'],
        'K6': res['ln_calls']}, 'whisper step')
    res.update(B=B, notes=notes, reference={'launches': ref_launches,
                                             'call_errs': errs,
                                             'loss_rel': rel,
                                             'grad_dist': dist})
    log(f'whisper step: B = {B} ({"; ".join(notes) or "as planned"})')
    model.eval().requires_grad_(False)
    return res


def run_whisper(dev, seed=SEED) -> dict:
    """Phase whisper: whisper-large-v3's widths with seeded random weights
    (f32): greedy serving of 4 × 30 s and the bundle's training step.
    Returns the results and `total`: every launch the phase counted."""
    import torch
    from reverb_tpu_torch.models.registry import init_model
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='reverb_whisper_') as tmp:
        bundle = init_model({'model': 'whisper',
                             'whisper_conf': WHISPER_CONF},
                            torch.Generator(device=dev).manual_seed(seed),
                            dev)
        model = bundle.model.eval().requires_grad_(False)
        n_params = sum(p.numel() for p in model.parameters())
        log(f'whisper: large-v3 widths, {n_params / 1e9:.3f}B params (f32), '
            f'built in {time.perf_counter() - t0:.1f} s')
        mel = whisper_mels(Path(tmp), seed, dev)
        res = {'params': n_params, 'serve': whisper_serve(dev, model, mel)}
        res['train'] = whisper_train(dev, seed, model, mel)
    del bundle, model
    gc.collect()
    torch.cuda.empty_cache()
    total = {}
    for d in (res['serve']['launches'],
              res['train']['reference']['launches'],
              {n: v * res['train']['steps']
               for n, v in res['train']['launches'].items()}):
        for n, v in d.items():
            total[n] = total.get(n, 0) + v
    res['total'] = total
    res['wall_s'] = time.perf_counter() - t0
    log(f'whisper phase: {res["wall_s"]:.1f} s; launches {total}')
    return res


# ------------------------------ phase 23: the other objectives ------------

OBJ_LAYERS = FAM_LAYERS        # encoder layers of every objective's model
OBJ_CTL_NEGATIVES = 20         # CTL's negatives a frame
OBJ_BIGRAM_V = 64              # the bigram LF-MMI model's token set
OBJ_LORA_RANK = 8
OBJ_TS_STUDENT = {'output_size': 256, 'attention_heads': 4,
                  'linear_units': 1024, 'num_blocks': 6, 'dec_blocks': 3,
                  'r_blocks': 1}           # presets.reverb_small's widths
OBJ_FSA_T = 512                # the LF-MMI frame loop timed alone


def objective_configs(kind: str, workdir: Path) -> dict:
    """presets.reverb_large() at OBJ_LAYERS layers as `kind`: the SSL
    objectives without LSL layers (their encoder calls take no category
    embedding, as in the JAX package) at their configs' defaults (BEST-RQ
    8192 codes of 16 dims, mask_prob 0.01 × 10 frames; wav2vec2 320 codes,
    100 negatives, mask_prob 0.065; w2v-BERT split 3 + 3); CTL with a
    dynamic chunk and OBJ_CTL_NEGATIVES negatives; the k2_model with a
    lfmmi_dir of the 10000 tokens (the dense unigram denominator) or, as
    `k2_bigram`, of OBJ_BIGRAM_V tokens with a random bigram.txt."""
    configs = presets_large()
    configs['encoder_conf'] = dict(configs['encoder_conf'],
                                   num_blocks=OBJ_LAYERS)
    if kind in ('bestrq', 'wav2vec2', 'w2vbert'):
        configs['dataset_conf'] = dict(configs['dataset_conf'],
                                       pass_cat_emb=False)
        configs['model'] = kind
    elif kind == 'ctl_model':
        configs['model'] = kind
        configs['encoder_conf'].update(use_dynamic_chunk=True,
                                       use_dynamic_left_chunk=True)
        configs['model_conf'] = dict(configs['model_conf'],
                                     n_negatives=OBJ_CTL_NEGATIVES,
                                     ctl_weight=1.0, logit_temp=0.1)
    else:
        vocab = VOCAB if kind == 'k2_model' else OBJ_BIGRAM_V
        d = workdir / f'lfmmi_{vocab}'
        d.mkdir(exist_ok=True)
        (d / 'tokens.txt').write_text(
            '<blank> 0\n' + ''.join(f't{i} {i}\n' for i in range(1, vocab - 1))
            + f'<sos/eos> {vocab - 1}\n')
        if kind == 'k2_bigram':
            rng = np.random.RandomState(SEED)
            K = vocab - 2
            p = rng.dirichlet(np.ones(K), size=K)
            (d / 'bigram.txt').write_text(''.join(
                f'{u + 1} {v + 1} {np.log(p[u, v]):.6f}\n'
                for u in range(K) for v in range(K)))
        configs.update(model='k2_model', output_dim=vocab)
        configs['model_conf'] = dict(configs['model_conf'],
                                     lfmmi_dir=str(d))
    return configs


def ts_run(dev, seed) -> dict:
    """Teacher-student: the teacher reverb_large (18 layers, frozen), the
    student at reverb_small's widths with the teacher's vocabulary;
    `ts_loss` with top-8 symmetric KL.  The f32 reference (every kernel
    call against its plain version, the student's gradient against f64),
    then timed bf16 steps at B = 8: K1 = 2 × 6 + 18 (the student's two
    forwards, the teacher's), K4 = 2 × 6, K5 = the student's LayerNorm
    calls + the teacher's, K6 = the student's."""
    import gc
    import torch
    from reverb_tpu_torch.models import presets
    from reverb_tpu_torch.models.asr_model import ModelConfig, build_model
    from reverb_tpu_torch.train.teacher_student import TSConfig, ts_loss
    tsc = TSConfig(ts_weight=0.5, top_k_entries=8)
    s_conf = presets.reverb_config(vocab_size=VOCAB, **OBJ_TS_STUDENT)

    def build(conf, dtype, s, train):
        cfg = ModelConfig.from_config(conf).with_compute_dtype(dtype)
        return build_model(cfg, dev, generator=torch.Generator(
            device=dev).manual_seed(s), train=train)

    teacher = build(presets_large(), torch.float32, seed, False)
    student = build(s_conf, torch.float32, seed + 1, True)

    def loss_fn(model, batch, generator=None):
        return ts_loss(model, teacher, batch, tsc, generator)
    ref = family_reference(student, loss_fn, train_batch(dev, 2, seed + 2,
                                                         VOCAB), dev,
                           {'K1', 'K4', 'K5', 'K6'}, 'ts reference')
    del teacher, student
    gc.collect()
    torch.cuda.empty_cache()
    teacher = build(presets_large(), torch.bfloat16, seed, False)
    student = build(s_conf, torch.bfloat16, seed + 1, True)
    t_ln, hooks = ln_call_counter(teacher)
    try:
        res = family_steps(student, loss_fn,
                           train_batch(dev, TRAIN_B, seed + 3, VOCAB), dev,
                           seed + 4, 2, 'ts (teacher reverb_large, student '
                           'reverb_small widths)')
    finally:
        for h in hooks:
            h.remove()
    t_per = t_ln[0] // res['steps']
    s_layers = OBJ_TS_STUDENT['num_blocks']
    expect_launches(res['launches'], {
        'K1': 2 * s_layers + LAYERS_ENC, 'K2': 0, 'K3': 0,
        'K4': 2 * s_layers, 'K5': res['ln_calls'] + t_per,
        'K6': res['ln_calls']}, 'ts step')
    res.update(reference=ref, teacher_ln=t_per)
    del teacher, student
    gc.collect()
    torch.cuda.empty_cache()
    return res


def lora_run(dev, seed, workdir: Path) -> dict:
    """LoRA: reverb_large at OBJ_LAYERS layers, rank-8 adapters on every
    attention projection, the base frozen (`lora_trainable_mask`); timed
    bf16 steps at B = 8 (K1 = K4 = 6; K6 only where a LayerNorm's input
    carries a gradient); then on an f32 copy (TF32 off) a serving call
    of the adapter model (B drawn N(0, 0.05²)) and, after `merge_lora`, a
    warm-up and a timed call of the merged model on the 164 s file (K1 6,
    K2 = K3 = 1): its CTM equals the adapter model's."""
    import gc
    import torch
    from reverb_tpu_torch.cli.reverb import ReverbASR
    from reverb_tpu_torch.models.asr_model import (ASRModel, ModelConfig,
                                                   build_model, compute_loss)
    from reverb_tpu_torch.models.modules import LayerNorm
    from reverb_tpu_torch.ops import layer_norm as ln
    from reverb_tpu_torch.text.tokenizer import init_tokenizer
    from reverb_tpu_torch.train import lora
    configs = presets_large()
    configs['encoder_conf'] = dict(configs['encoder_conf'],
                                   num_blocks=OBJ_LAYERS)
    cfg = ModelConfig.from_config(configs)
    model = build_model(cfg.with_compute_dtype(torch.bfloat16), dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            seed), train=True)
    lora.inject_lora(model, torch.Generator(device=dev).manual_seed(seed + 1),
                     rank=OBJ_LORA_RANK, alpha=OBJ_LORA_RANK)
    mask = lora.lora_trainable_mask(model)
    n_train = sum(p.numel() for n, p in model.named_parameters() if mask[n])
    grad_ln = [0]

    def hook(mod, args, out):
        if args[0].is_cuda and ln.eligible(args[0]) and args[0].requires_grad:
            grad_ln[0] += 1
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, LayerNorm)]
    try:
        res = family_steps(
            model, lambda m, b, g=None: compute_loss(m, b, g),
            train_batch(dev, TRAIN_B, seed + 2, VOCAB), dev, seed + 3, 2,
            f'lora (rank {OBJ_LORA_RANK}, {n_train / 1e6:.2f}M trainable)')
    finally:
        for h in hooks:
            h.remove()
    expect_launches(res['launches'], {
        'K1': OBJ_LAYERS, 'K2': 0, 'K3': 0, 'K4': OBJ_LAYERS,
        'K5': res['ln_calls'], 'K6': grad_ln[0] // res['steps']},
        'lora step')
    # serving, f32: the adapter model, then the merged one
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with torch.device('meta'):
        f32 = ASRModel(cfg)
    lora.lora_modules(f32, sd)
    f32 = f32.to_empty(device=dev)
    f32.load_state_dict(sd, strict=True)
    f32.eval().requires_grad_(False)
    # two steps at the warm-up's learning rate leave B near zero: give the
    # adapters B ~ N(0, 0.05²), as a trained adapter's, so merging moves
    # every adapted weight
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    with torch.no_grad():
        for m in f32.modules():
            if getattr(m, 'lora_B', None) is not None:
                m.lora_B.normal_(generator=g).mul_(0.05)
    configs['tokenizer'] = 'char'
    configs['tokenizer_conf'] = {'symbol_table_path': str(workdir /
                                                          'units.txt')}
    write_units(workdir / 'units.txt')
    asr = ReverbASR.from_model(configs, f32, init_tokenizer(configs))
    n_samples = 400 + 160 * (N_CHUNKS * CHUNK - 1)
    wav = workdir / 'long.wav'
    write_wav(wav, n_samples, seed)
    sharpen_ctc_head(asr, asr.compute_feats(str(wav)))
    adapter_ctm = asr.transcribe_modes(str(wav), MODES, format='ctm')
    lora.merge_lora(f32)
    if any('lora_' in n for n, _ in f32.named_parameters()):
        raise AssertionError('merge_lora left an adapter')
    asr.transcribe_modes(str(wav), MODES, format='ctm')
    torch.cuda.synchronize()
    diar_zero_launch_counts()
    t0 = time.perf_counter()
    merged_ctm = asr.transcribe_modes(str(wav), MODES, format='ctm')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve = diar_launch_counts()
    if serve['K1'] != OBJ_LAYERS or serve['K2'] != 1 or serve['K3'] != 1 \
            or serve['K4'] or serve['K6'] or not serve['K5']:
        raise AssertionError(f'lora serving launches {serve}')
    if merged_ctm != adapter_ctm:
        raise AssertionError('lora: the merged model decodes differently '
                             'from the adapter model')
    rows = sum(len(v.splitlines()) for v in merged_ctm)
    if not rows:
        raise AssertionError('lora serving: empty CTM')
    log(f'lora serving (f32, merged, {n_samples / 16000:.1f} s): '
        f'{wall:.4f} s a call, launches {serve}; {rows} CTM rows equal to '
        f'the adapter model\'s')
    res.update(serve_launches=serve, serve_wall=wall, ctm_rows=rows,
               trainable=n_train)
    del asr, f32
    gc.collect()
    torch.cuda.empty_cache()
    return res


def fsa_loop_times(dev, seed) -> dict:
    """The LF-MMI denominators alone at B = 8, T = OBJ_FSA_T: the dense
    unigram recursion over V = 10000 and the bigram graph over
    OBJ_BIGRAM_V tokens, forward and forward + backward (ms)."""
    import torch
    from reverb_tpu_torch.ops import fsa
    gen = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.full((TRAIN_B,), OBJ_FSA_T, device=dev)
    lens[1:] -= 37
    out = {}
    K = OBJ_BIGRAM_V - 2
    rng = np.random.RandomState(seed)
    arcs = fsa.bigram_den_arcs(
        np.log(rng.dirichlet(np.ones(K), size=K)).astype(np.float32), 0,
        tokens=np.arange(1, K + 1, dtype=np.int32))
    src, dst, lab = (torch.as_tensor(a, dtype=torch.int64, device=dev)
                     for a in arcs[:3])
    wgt, fin = (torch.as_tensor(a, device=dev) for a in (arcs[3], arcs[5]))
    for name, V in (('unigram', VOCAB), ('bigram', OBJ_BIGRAM_V)):
        x = torch.randn(TRAIN_B, OBJ_FSA_T, V, device=dev, generator=gen)
        uni = torch.full((V,), -math.log(V - 2), device=dev)

        def score(logp):
            if name == 'unigram':
                return fsa.dense_unigram_den_score(logp, lens, uni, 0)
            return fsa.fsa_forward_score(logp, lens, src, dst, lab, wgt,
                                         arcs[4], fin)
        for grad in (False, True):
            xs = x.clone().requires_grad_(grad)
            times = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.set_grad_enabled(grad):
                    s = score(torch.log_softmax(xs, -1))
                    if grad:
                        s.sum().backward()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            if not torch.isfinite(s).all() or (grad and not torch.isfinite(
                    xs.grad).all()):
                raise AssertionError(f'lfmmi {name}: non-finite')
            out[f'{name}_{"fwd_bwd" if grad else "fwd"}_ms'] = times[1] * 1e3
    log(f'lfmmi frame loop alone (B = {TRAIN_B}, T = {OBJ_FSA_T}): '
        + ', '.join(f'{k} {v:.1f}' for k, v in out.items()))
    return out


def run_objectives(dev, seed=SEED) -> dict:
    """Phase objectives: BEST-RQ, wav2vec2, w2v-BERT, CTL and the LF-MMI
    k2_model (unigram at V 10000, bigram at V 64) through their registry
    bundles (`family_train`: the f32 reference, then timed bf16 steps at
    B = 8; K1 = K4 = 6 a step), the teacher-student step, the LoRA step
    and its merged serving call, and the LF-MMI frame loop alone.
    Returns the results and `total`: every launch the phase counted."""
    import torch
    t0 = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory(prefix='reverb_objectives_') as tmp:
        workdir = Path(tmp)
        for kind in ('bestrq', 'wav2vec2', 'w2vbert', 'ctl_model',
                     'k2_model', 'k2_bigram'):
            res[kind] = family_train(
                dev, seed, objective_configs(kind, workdir), kind,
                {'K1', 'K4', 'K5', 'K6'}, OBJ_LAYERS,
                lambda B, s, vocab: train_batch(dev, B, s, vocab), TRAIN_B)
        res['ts'] = ts_run(dev, seed)
        res['lora'] = lora_run(dev, seed, workdir)
    res['fsa'] = fsa_loop_times(dev, seed)
    total = {}
    for k, r in res.items():
        if k == 'fsa':
            continue
        parts = [r['reference']['launches'] if 'reference' in r else {},
                 {n: v * r['steps'] for n, v in r['launches'].items()},
                 r.get('serve_launches', {})]
        for d in parts:
            for n, v in d.items():
                total[n] = total.get(n, 0) + v
    res['total'] = total
    res['wall_s'] = time.perf_counter() - t0
    log(f'objectives phase: {res["wall_s"]:.1f} s; launches {total}')
    torch.cuda.empty_cache()
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--phases', default=','.join(ALL_PHASES),
                    help='comma list of kernels, serve, train, modes, '
                         'stream, diar, recipe, context, tools, remat, '
                         'diartrain, int8, export, parallel, families, '
                         'paraformer, whisper, objectives (default all; the '
                         'result lines need all eighteen), or beam: the '
                         'K2/K3 and K2b checks alone')
    ap.add_argument('--parallel-child', default=None,
                    help=argparse.SUPPRESS)
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
    if args.parallel_child:
        # one rank of phase parallel's two-rank runs
        return parallel_child(args.parallel_child)
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
    # wall seconds of each phase (the build's included in the first)
    phase_s, t_mark = {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now
        log(f'phase {name}: {phase_s[name]:.1f} s')

    if 'kernels' in phases:
        # phases 3-4, 6-7: kernels against their plain versions
        k1 = check_k1(dev)
        sdpa = sdpa_yardstick(dev)
        fwd_err, bt = check_beam(dev, SEED)
        k4 = check_k1_mask_k4(dev)[torch.bfloat16]
        lnr = check_ln(dev)[torch.bfloat16]
        mark('kernels')
    if phases & {'serve', 'modes', 'stream', 'context', 'tools', 'int8',
                  'export', 'parallel'}:
        with tempfile.TemporaryDirectory(prefix='reverb_smoke_') as tmp:
            served = serving_setup(dev, SEED, Path(tmp))
            mark('serving setup')
            if 'serve' in phases:
                # phase 5: the serving path
                launches, walls, audio_s, fallback = run_slice(dev, *served)
                mark('serve')
            if 'modes' in phases:
                # phase 9: the six CLI modes
                modes = run_modes(dev, *served)
                mark('modes')
            if 'stream' in phases:
                # phase 10: streaming
                stream = run_stream(dev, *served)
                mark('stream')
            if 'context' in phases:
                # phase 13: context biasing (K2b; serving and training)
                context = run_context(dev, *served)
                mark('context')
            if 'tools' in phases:
                # phase 14: alignment, transcribe, the app
                tools = run_tools(dev, *served, Path(tmp))
                mark('tools')
            if 'int8' in phases:
                # phase 17: --quantize int8 serving (and static scales)
                int8 = run_int8(dev, *served)
                mark('int8')
            if 'export' in phases:
                # phase 18: bin.export (pt2 programs, the aot kernel dir)
                export = run_export(dev, *served, Path(tmp))
                mark('export')
            if 'parallel' in phases:
                # phase 19, serving: data_parallel over the cards
                par_serve = parallel_serve(served[0], served[1])
                mark('parallel serving')
            del served
    if 'train' in phases:
        # phase 8: the training path
        train_reference_check(dev, SEED)
        t_launch, step_ms, peak = run_train(dev, SEED)
        if args.profile:
            profile_train(dev, SEED)
        mark('train')
    if 'diar' in phases:
        # phase 11: diarization, both routes
        diar = run_diar(dev, SEED)
        mark('diar')
    if 'recipe' in phases:
        # phase 12: the dataset path (train, recognize, get_loss, average)
        recipe = run_recipe(dev, SEED)
        mark('recipe')
    if 'remat' in phases:
        # phase 15: gradient checkpointing, the new training options,
        # device_feats through bin.train
        remat = run_remat(dev, SEED)
        mark('remat')
    if 'diartrain' in phases:
        # phase 16: diarization training (K6 on the TDNN)
        diartrain = run_diartrain(dev, SEED)
        mark('diartrain')
    if 'parallel' in phases:
        # phase 19: the sharded training step (DDP, ZeRO-1/2, ZeRO-3, TP)
        par = run_parallel(dev, SEED)
        mark('parallel')
    if 'families' in phases:
        # phase 20: MoE, the transducer, the alternative encoders
        families = run_families(dev, SEED)
        mark('families')
    if 'paraformer' in phases:
        # phase 21: the Paraformer family, the transformer encoder
        para = run_paraformer(dev, SEED)
        mark('paraformer')
    if 'whisper' in phases:
        # phase 22: Whisper at large-v3's widths, serving and a step
        whisper = run_whisper(dev, SEED)
        mark('whisper')
    if 'objectives' in phases:
        # phase 23: SSL, CTL, LF-MMI, teacher-student, LoRA
        objectives = run_objectives(dev, SEED)
        mark('objectives')
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
                             int8, export, par, par_serve, families, para,
                             whisper, objectives)
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
        f' s, aot {export["aot_s"]:.1f} s; the sharded bf16 step at world '
        f'1 {par["world1"]["bf16"]["ms"]:.1f} ms '
        f'{par["world1"]["bf16"]["peak_gib"]:.2f} GiB; two and four '
        f'ranks on one card over gloo: '
        + ', '.join(f'{n} ' + (f'{r["ms"]:.1f} ms {r["peak_gib"]:.2f} GiB'
                               if 'ms' in r else 'cannot run')
                    for run in ('gloo', 'gloo4')
                    for n, r in par[run]['ranks'][0].items()
                    if n not in ('total', 'expect'))
        + f'; data_parallel={par_serve["n"]} serving '
        f'{par_serve["wall"]:.4f} s; families {families["wall_s"]:.1f} s: '
        f'MoE serving {families["moe"]["serve"]["walls"][1]:.4f} s, '
        f'transducer step {families["transducer"]["train"]["ms"]:.1f} ms, '
        + ', '.join(f'{k} step {r["ms"]:.1f} ms'
                    for k, r in families['alt'].items())
        + f'; paraformer {para["wall_s"]:.1f} s: transcribe --paraformer '
        f'{para["serve"]["transcribe_s"][1]:.3f} s for {PARA_AUDIO_S:.0f} s, '
        f'SANM '
        f'bin.train {para["bin_train"]["step_ms"]:.1f} ms/step, conformer '
        f'Paraformer step {para["conformer"]["ms"]:.1f} ms, transformer step '
        f'{para["transformer"]["ms"]:.1f} ms, transformer serving '
        f'{para["transformer_serve"]["walls"][1]:.4f} s'
        f'; whisper {whisper["wall_s"]:.1f} s: greedy serving '
        f'{whisper["serve"]["wall_s"]:.3f} s ({whisper["serve"]["steps"]} '
        f'positions, {whisper["serve"]["ms_per_token"]:.2f} ms each), step '
        f'{whisper["train"]["ms"]:.1f} ms at B={whisper["train"]["B"]}; '
        f'objectives {objectives["wall_s"]:.1f} s: '
        + ', '.join(f'{k} step {objectives[k]["ms"]:.1f} ms'
                    for k in ('bestrq', 'wav2vec2', 'w2vbert', 'ctl_model',
                              'k2_model', 'k2_bigram', 'ts', 'lora'))
        + f', LoRA merged serving {objectives["lora"]["serve_wall"]:.4f} s'
        + '; phase walls ' + ', '.join(f'{n} {s:.1f} s'
                                       for n, s in phase_s.items())
        + f'; on {smi}')
    print(smi_line())
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def kernel_records(k1, sdpa, fwd_err, bt, k4, lnr, launches, n_calls,
                   t_launch, fallback, modes, stream, diar, recipe, context,
                   tools, remat, diartrain, int8, export, par, par_serve,
                   families, para, whisper, objectives):
    """The {"kernels": [...]} entries: launches on the paths (in all, per
    serving call, per training step, per six-mode call, per streaming hop,
    per pool step, per diarization call of either route, and on the
    dataset path: per bin.train step (CV included), per dynamic-chunk
    step, per get_loss utterance and per recognize batch; K2/K3 also per
    call of the long-hypothesis path; per biased serving call, with and
    without the uncapped tail, and per deep-biasing training step; per
    aligned WAV, per transcribe call and per app POST of the tools;
    per sharded step of each parallel form, rank 0's, and per
    data-parallel serving call),
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
    # phase parallel: a step of the sharded f32 and bf16 step at world 1
    # and of each multi-rank form (rank 0's first), a data-parallel serving
    # call; the total is every launch the phase read, each step and call
    # counted on its own (the unwrapped reference steps, every rank's
    # steps and the reference, first and timed serving calls included)
    w1 = par['world1']
    runs = {'parallel_world1_f32_step': w1['f32']['launches'],
            'parallel_world1_step': w1['bf16']['launches']}
    totals = [w1['total'], par_serve['total']]
    for run in ('gloo', 'gloo4', 'nccl2', 'nccl4'):
        if run not in par:
            continue
        totals.append(par[run]['total'])
        for f, r in par[run]['ranks'][0].items():
            if f != 'total' and 'launches' in r:
                runs[f'parallel_{run}_{f}_f32_step'] = r['f32']['launches']
                runs[f'parallel_{run}_{f}_step'] = r['launches'][0]
    par_total = {n: sum(t.get(n, 0) for t in totals)
                 for n in ('K1', 'K2', 'K3', 'K4', 'K5', 'K6')}
    for n in par_total:
        for run, got in runs.items():
            per[n][run] = got.get(n, 0)
        per[n]['parallel_serve'] = par_serve['launches'].get(n, 0)
    # phase families: a MoE serving call, the transducer's encoder over
    # the 8 chunks, a bin.train run, and a step of each family's model
    fam_runs = {
        'families_moe_serve': families['moe']['serve']['launches'],
        'families_transducer_encoder_8_chunks':
            families['transducer']['serve']['launches'],
        'families_transducer_bin_train_resumed':
            families['transducer']['bin_train']['runs'][1]['launches'],
        'families_moe_train_step': families['moe']['train']['launches'],
        'families_transducer_train_step':
            families['transducer']['train']['launches'],
        **{f'families_{k}_train_step': r['launches']
           for k, r in families['alt'].items()}}
    for n in ('K1', 'K2', 'K3', 'K4', 'K5', 'K6'):
        for run, got in fam_runs.items():
            per[n][run] = got.get(n, 0)
    # phase paraformer: a transcribe --paraformer call, a SANM bin.train
    # step (its CV batches beside), a step of the conformer Paraformer and
    # of the transformer asr_model, a transformer serving call
    bt_p = para['bin_train']
    para_runs = {
        'paraformer_transcribe': para['serve']['launches'],
        'paraformer_sanm_f32_reference_step':
            para['sanm_reference']['launches'],
        'paraformer_conformer_train_step': para['conformer']['launches'],
        'transformer_train_step': para['transformer']['launches'],
        'transformer_serve': para['transformer_serve']['launches']}
    for n in ('K1', 'K2', 'K3', 'K4', 'K5', 'K6'):
        for run, got in para_runs.items():
            per[n][run] = got.get(n, 0)
        per[n]['paraformer_sanm_bin_train_step_with_cv'] = (
            bt_p['launches'].get(n, 0) / bt_p['steps'])
    # phases whisper and objectives: a Whisper greedy serving call and
    # step, a step of each objective, the LoRA model's merged serving call
    new_runs = {'whisper_serve': whisper['serve']['launches'],
                'whisper_train_step': whisper['train']['launches'],
                'objectives_lora_merged_serve':
                    objectives['lora']['serve_launches'],
                **{f'objectives_{k}_train_step': objectives[k]['launches']
                   for k in ('bestrq', 'wav2vec2', 'w2vbert', 'ctl_model',
                             'k2_model', 'k2_bigram', 'ts', 'lora')}}
    for n in ('K1', 'K2', 'K3', 'K4', 'K5', 'K6'):
        for run, got in new_runs.items():
            per[n][run] = got.get(n, 0)
    other = {n: (par_total.get(n, 0) + int8['launches'].get(n, 0)
                 + families['total'].get(n, 0) + para['total'].get(n, 0)
                 + whisper['total'].get(n, 0)
                 + objectives['total'].get(n, 0)
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
