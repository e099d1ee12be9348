"""Training cells: a registry family's step under `make_train_step`, fed
from a seeded pool of batches, for a fixed window.

Set-up builds the one step object (model from seeded weights, Adam state,
the step function) and drives it through the mix's first `checked_steps`
steps, which also warm every shape up; those steps are the ones the plain
reference follows after the window.  The window then runs the same object
on the pool's batches in turn until `seconds` have passed; each step ends
in the host read of its loss.

`--trace 1` first profiles `trace_steps` steps in the timing window (host
ops and the card, no input shapes), then runs the same batches again in
the shapes window (host ops with their input shapes), then runs the
window unprofiled; the per-layer metrics of rates read those unprofiled
steps.  The launch counters that the cell's metrics name are read around
the timing window and around the measured window.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import audio, core, counts
from benchmark import weights as W


def whisper_registry_conf(c: Dict) -> Dict:
    """The port's registry config for a Whisper of HF config `c`."""
    return {'model': 'whisper', 'whisper_conf': {
        'n_mels': c['num_mel_bins'], 'n_audio_ctx': c['max_source_positions'],
        'n_audio_state': c['d_model'],
        'n_audio_head': c['encoder_attention_heads'],
        'n_audio_layer': c['encoder_layers'], 'n_vocab': c['vocab_size'],
        'n_text_ctx': c['max_target_positions'],
        'n_text_state': c['d_model'],
        'n_text_head': c['decoder_attention_heads'],
        'n_text_layer': c['decoder_layers']}}


def make_pool(c: Dict, mix: Dict, seed: int, device) -> List[Dict]:
    """`pool_batches` batches of `batch` clips of `clip_s` seconds of
    speech-like audio as log-mel, each clip distinct, with targets: the
    prompt, a body of text tokens and eot, padded with -1.  The body
    lengths are one fixed set spread over `text_tokens`, dealt to the
    clips in a seeded order, so every seed does the same work."""
    B, P = mix['batch'], mix['pool_batches']
    n = int(mix['clip_s'] * audio.SR)
    g = torch.Generator(device='cpu')
    g.manual_seed(int(seed) % (1 << 63))
    clips = torch.stack([audio.speech_like(n, seed * 1000 + i, device)
                         for i in range(B * P)]).to(torch.float32) / 32768.0
    mel = audio.whisper_log_mel(clips, c['num_mel_bins'])
    del clips
    lo, hi = mix['text_tokens']
    lens = torch.tensor([lo + round((hi - lo) * i / (B * P - 1))
                         for i in range(B * P)])
    lens = lens[torch.randperm(B * P, generator=g)]
    prompt = torch.tensor(mix['prompt'])
    body = torch.randint(0, mix['eot'], (B * P, hi), generator=g)
    target = torch.cat([prompt[None].expand(B * P, -1), body], 1)
    L = len(mix['prompt']) + lens
    pos = torch.arange(target.shape[1])[None, :]
    target[pos >= L[:, None]] = -1
    target[torch.arange(B * P), L - 1] = mix['eot']
    pool = []
    for b in range(P):
        rows = slice(b * B, (b + 1) * B)
        pool.append({'feats': mel[rows].contiguous(),
                     'feats_lengths': torch.full((B,), mel.shape[1],
                                                 device=device),
                     'target': target[rows].to(device),
                     'target_lengths': L[rows].to(device)})
    return pool


class TrainCell:
    """The program's side: the step object and what its first steps
    showed."""

    def __init__(self, cell, seed: int, device):
        from reverb_tpu_torch.models.registry import init_model
        from reverb_tpu_torch.train.trainer import (TrainConfig,
                                                    build_optimizer,
                                                    make_train_step)
        from benchmark.reference import whisper as ref
        self.c = cell.config
        self.mix = cell.traffic
        self.seed = seed
        self.device = device
        self.marks = [('imports', time.perf_counter())]
        self.spec = ref.spec(self.c)
        sd = W.state_dict(self.spec, seed, device)
        self.marks.append(('weights', time.perf_counter()))
        self.bundle = init_model(whisper_registry_conf(self.c), device=device,
                                 state_dict=sd)
        del sd
        self.marks.append(('model', time.perf_counter()))
        self.model = self.bundle.model
        t = self.c['training']
        self.tc = TrainConfig.from_config({
            'optim': t['optim'], 'optim_conf': {'lr': t['lr']},
            'scheduler': t['scheduler'],
            'scheduler_conf': {'warmup_steps': t['warmup_steps']},
            'grad_clip': t['grad_clip'], 'accum_grad': 1})
        self.opt, _ = build_optimizer(self.tc, self.model)
        self.step = make_train_step(self.model.cfg, self.opt, 1,
                                    self.tc.grad_clip,
                                    loss_fn=self.bundle.loss_fn)
        self.marks.append(('optimizer', time.perf_counter()))
        self.pool = make_pool(self.c, self.mix, seed, device)
        self.marks.append(('pool', time.perf_counter()))
        self.next = 0

    def run_step(self) -> Dict:
        batch = self.pool[self.next % len(self.pool)]
        self.next += 1
        return self.step(self.model, batch)

    def checked_steps(self) -> Dict:
        """The first steps, with the readings the reference is held to:
        each loss, the first step's gradient per leaf as Adam took it (its
        first moment over 1 − b1), and each leaf's change after the last
        of them."""
        losses, grads = [], None
        b1 = self.opt.b1
        names = [self.opt.names[i] for i in self.opt.train_idx]
        for s in range(self.mix['checked_steps']):
            m = self.run_step()
            losses.append(m['loss'])
            if s == 0:
                norms = torch.stack(torch._foreach_norm(self.opt.mu)).cpu()
                grads = {n: float(v) / (1.0 - b1)
                         for n, v in zip(names, norms.tolist())}
        self.marks.append(('checked steps', time.perf_counter()))
        own = dict(self.model.named_parameters())
        change = {}
        with torch.no_grad():
            for name, p0 in W.leaves(self.spec, self.seed, self.device):
                change[name] = float((own[name] - p0).norm())
        self.marks.append(('readings', time.perf_counter()))
        return {'losses': losses, 'grad_norms': grads,
                'change_norms': change}

    def close(self):
        del self.model, self.bundle, self.opt, self.step
        self.pool = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep=None) -> float:
    """Worst leaf of |‖prog‖ − ‖ref‖| over the larger of the leaf's
    and the median leaf's reference norm."""
    names = [n for n in ref if keep is None or keep(n)]
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def compare(prog: Dict, ref: Dict, limits: Dict, grad_floor: float
            ) -> Dict[str, Dict]:
    """The cell's numbers beside their limits.  Leaves whose reference
    gradient is under `grad_floor` of the median leaf's move by round-off
    alone under Adam and are left out of the change."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog['losses'],
                                                       ref['losses']))
    rg = ref['grad_norms']
    gmed = statistics.median(rg.values())
    out = {'loss_gap': loss_gap,
           'grad_gap': leaf_gap(prog['grad_norms'], rg),
           'update_gap': leaf_gap(prog['change_norms'], ref['change_norms'],
                                  lambda n: rg[n] >= grad_floor * gmed)}
    return {k: {'value': v, 'limit': limits[k], 'ok': bool(v <= limits[k])}
            for k, v in out.items()}


def step_flops(cell, batch) -> float:
    lens = (batch['target_lengths'] - 1).tolist()
    return counts.whisper_step_flops(cell.config, batch['feats'].shape[1],
                                     lens)


class Context:
    """What the per-layer readers read."""


def run_control(cell, seed: int, device) -> tuple:
    """The control: the reference in the program's place at the next
    precision down (TF32 matmuls and convolutions for a float32
    configuration), held to the same numbers."""
    from benchmark.reference import whisper as ref
    pool = make_pool(cell.config, cell.traffic, seed, device)
    checked = [pool[i % len(pool)]
               for i in range(cell.traffic['checked_steps'])]
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    low = ref.train_steps(cell.config, cell.config['training'], seed, checked,
                          device)
    core.set_precision(cell.config['compute_dtype'])
    full = ref.train_steps(cell.config, cell.config['training'], seed,
                           checked, device)
    checks = compare(low, full, cell.traffic['limits'],
                     cell.traffic['grad_floor'])
    result = {'correct': all(v['ok'] for v in checks.values()),
              'attempted': len(checked), 'failed': 0, 'metrics': {},
              'peak_bytes': 0, 'busy_s': None, 'traced_window_s': None}
    return result, checks


def sound(m: Dict) -> bool:
    return bool(np.isfinite(m['loss']) and m['skipped'] == 0.0)


def traced_steps(prog, n: int, tmp, counters: List[str]) -> tuple:
    """`n` steps in the timing window, then the same batches again in the
    shapes window: (timing trace, its seconds, shapes trace, the
    counters' launches in the timing window, the steps' soundness)."""
    start = prog.next
    ok = []
    before = core.read_counters(counters)
    with core.TraceWindow(tmp) as timing:
        for _ in range(n):
            with torch.profiler.record_function('span:step'):
                ok.append(sound(prog.run_step()))
    launches = core.counted(before, core.read_counters(counters))
    # read before the next window opens: a new profiler session drops the
    # device events that the last one left to export
    timing_trace = timing.trace()
    prog.next = start
    with core.TraceWindow(tmp, shapes=True) as shapes:
        for _ in range(n):
            ok.append(sound(prog.run_step()))
    return (timing_trace, timing.window_s, shapes.trace(), launches, ok)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        tmp, program=TrainCell, reference=None, control: bool = False
        ) -> tuple:
    from benchmark.reference import whisper as ref
    if control:
        return run_control(cell, seed, device)
    cuda = device.type == 'cuda'
    flags = core.set_precision(cell.config['compute_dtype'])
    prog = program(cell, seed, device)
    readings = prog.checked_steps()
    checked = [prog.pool[i % len(prog.pool)]
               for i in range(cell.traffic['checked_steps'])]
    checked = [{k: v.clone() for k, v in b.items()} for b in checked]
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    marks = getattr(prog, 'marks', [])
    phases = ', '.join(f'{n} {t - p:.2f}' for (n, t), p in zip(
        marks, [t_start] + [t for _, t in marks]))
    core.log(f'set-up {setup_s:.2f} s ({phases}); first steps: losses '
             f'{readings["losses"]}')

    ctx = Context()
    ctx.trace = ctx.shapes_trace = ctx.window_s = None
    ctx.traced_steps, ctx.launches = 0, {}
    counters = core.counter_names(cell)
    ok = []
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if trace:
        ctx.traced_steps = cell.traffic['trace_steps']
        (ctx.trace, ctx.window_s, ctx.shapes_trace, ctx.launches,
         ok) = traced_steps(prog, ctx.traced_steps, tmp, counters)
    walls, flops = [], 0.0
    before = core.read_counters(counters)
    t0 = time.perf_counter()
    while True:
        batch = prog.pool[prog.next % len(prog.pool)]
        s0 = time.perf_counter()
        ok.append(sound(prog.run_step()))
        walls.append(time.perf_counter() - s0)
        flops += step_flops(cell, batch)
        if time.perf_counter() - t0 >= seconds:
            break
    window = time.perf_counter() - t0
    launches = {k: v / len(walls) for k, v in
                core.counted(before, core.read_counters(counters)).items()}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    audio_s = len(walls) * cell.traffic['batch'] * cell.traffic['clip_s']
    q = statistics.quantiles(walls, n=4) if len(walls) > 1 else walls * 3
    core.log(f'{len(walls)} steps in {window:.3f} s; step ms min '
             f'{min(walls) * 1e3:.1f} q1 {q[0] * 1e3:.1f} median '
             f'{q[1] * 1e3:.1f} q3 {q[2] * 1e3:.1f} max '
             f'{max(walls) * 1e3:.1f}; launches a step {launches}')

    ctx.step_walls = walls
    ctx.flops = flops
    ctx.window_wall = sum(walls)
    ctx.peak_flops = core.PEAK_FLOPS[cell.config['compute_dtype']]
    ctx.window_peak_bytes = peak
    prog.close()

    # the reference follows the first steps, after the program is freed
    ref_out = (reference or ref.train_steps)(
        cell.config, cell.config['training'], seed, checked, device)
    checks = compare(readings, ref_out, cell.traffic['limits'],
                     cell.traffic['grad_floor'])
    failed = ok.count(False)
    correct = all(v['ok'] for v in checks.values()) and failed == 0
    result = {'correct': correct, 'attempted': len(ok), 'failed': failed,
              'precision': flags, 'steps': len(walls), 'window_s': window,
              'launches': launches}
    if trace:
        metrics = core.read_per_layer(cell, ctx)
        result['breakdown'] = ctx.trace.breakdown(
            core.trace_window_us(ctx.trace))
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m['name'] == 'setup_s':
                metrics['setup_s'] = {'value': setup_s, 'unit': 's'}
            elif m['name'] == 'train_audio_s_per_s':
                metrics[m['name']] = {'value': audio_s / window,
                                      'unit': m['unit']}
    result['metrics'] = metrics
    result['peak_bytes'] = peak
    result['busy_s'] = ctx.trace.busy_s() if ctx.trace else None
    result['traced_window_s'] = ctx.window_s
    return result, checks
