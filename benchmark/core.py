"""The harness's common parts: the cell's files, the device, the traced
window, the result line and the import guard.

A cell of BENCHMARK.json names a configuration (configs/<name>.json) and a
traffic mix (traffic/<name>.json).  The mix's `kind` names the driver
(drivers/<kind>.py) that sets the cell up, runs its window and judges its
outputs.  Each per-layer metric is a file metrics/<name>.json naming its
reader (readers/<reader>.py) and the reader's parameters.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from bisect import bisect_right
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# whole top-level module names that no process of the benchmark may load
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'reverb_tpu', 'chip_smoke', 'bench')

# published dense peaks of one H100 SXM (NVIDIA's data sheet) at 700 W
PEAK_FLOPS = {'bfloat16': 989e12, 'float16': 989e12, 'tf32': 495e12,
              'float32': 67e12}
PEAK_BYTES_S = 3.35e12


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a missing file)."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic mix
    and metrics, read from the files their names point at."""

    def __init__(self, name: str, bench_path: Optional[Path] = None):
        bench_path = bench_path or ROOT / 'BENCHMARK.json'
        self.bench = load_json(bench_path)
        self.root = bench_path.parent
        cells = {w['name']: w for w in self.bench['workloads']}
        if name not in cells:
            raise BenchError(f'no workload {name!r} in {bench_path}')
        self.workload = cells[name]
        self.name = name
        confs = {c['name']: c for c in self.bench['configs']}
        self.config_entry = confs[self.workload['config']]
        self.config = load_json(self.root / self.config_entry['file'])
        self.traffic = load_json(self.root / 'benchmark' / 'traffic'
                                 / f"{self.workload['traffic']}.json")
        self.chips = int(self.workload['chips'])
        self.end_to_end = [m for m in self.bench['end_to_end']
                           if name in m.get('workloads', [name])]
        self.per_layer = [m for m in self.bench['per_layer']
                          if name in m.get('workloads', [name])]

    def driver(self):
        return importlib.import_module(
            f"benchmark.drivers.{self.traffic['kind']}")

    def metric_entry(self, name: str) -> dict:
        return load_json(self.root / 'benchmark' / 'metrics' / f'{name}.json')


def list_cells(bench_path: Optional[Path] = None) -> List[dict]:
    """Every workload with its configuration file, traffic file and
    per-layer metric files, as the harness finds them."""
    bench_path = bench_path or ROOT / 'BENCHMARK.json'
    bench = load_json(bench_path)
    out = []
    for w in bench['workloads']:
        cell = Cell(w['name'], bench_path)
        out.append({'workload': w['name'],
                    'config': cell.config_entry['file'],
                    'traffic': f"benchmark/traffic/{w['traffic']}.json",
                    'kind': cell.traffic['kind'],
                    'metrics': [m['name'] for m in cell.per_layer],
                    'readers': [cell.metric_entry(m['name'])['reader']
                                for m in cell.per_layer]})
    return out


# ------------------------------ the device ------------------------------

def require_cards(count: int):
    """Raise unless CUDA is there with at least `count` cards."""
    import torch
    if not torch.cuda.is_available():
        raise BenchError('torch.cuda.is_available() is false: the '
                         'benchmark measures the card and has no CPU mode')
    if torch.cuda.device_count() < count:
        raise BenchError(f'the cell needs {count} cards, '
                         f'{torch.cuda.device_count()} found')


def card_info() -> Dict:
    """nvidia-smi's name and power limit of card 0 (None where it is not
    there), written beside every number."""
    smi = shutil.which('nvidia-smi')
    if smi is None:
        return {}
    try:
        out = subprocess.run(
            [smi, '--query-gpu=name,power.limit,clocks.max.sm',
             '--format=csv,noheader', '-i', '0'], capture_output=True,
            text=True, timeout=20, check=False).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return {}
    parts = [p.strip() for p in out.split(',')]
    return {'name': parts[0], 'power_limit': parts[1],
            'max_sm_clock': parts[2]} if len(parts) == 3 else {}


def device_block(count: int, peak_bytes: int) -> Dict:
    import torch
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': count, 'memory_peak_bytes': int(peak_bytes)}


def set_precision(dtype_name: str):
    """Full f32 matmuls and convolutions (TF32 off) for a float32
    configuration, as it states; returns the flags the run ran with."""
    import torch
    if dtype_name == 'float32':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return {'matmul_tf32': bool(torch.backends.cuda.matmul.allow_tf32),
            'cudnn_tf32': bool(torch.backends.cudnn.allow_tf32)}


def kernel_cache_env():
    """Triton's cache inside the checkout, at a fixed path (the port's own
    kernel library lives in reverb_tpu_torch/_build/, also inside it), and
    no JAX for a library that would load it by itself."""
    os.environ.setdefault('TRITON_CACHE_DIR',
                          str(ROOT / 'benchmark' / '.cache' / 'triton'))
    os.environ.setdefault('USE_FLAX', '0')


def scratch_dir(name: str) -> Path:
    """A directory under the run's TMPDIR (never a fixed /tmp path)."""
    import tempfile
    d = Path(tempfile.mkdtemp(prefix=f'{name}-'))
    return d


# ------------------------------ spans and the trace ----------------------

class Trace:
    """The device side of a torch.profiler window, read from its chrome
    trace: kernels (with memcpy/memset) as intervals, the host launch of
    each, the host ops (with recorded input shapes) and annotations."""

    def __init__(self, events: List[dict]):
        self.kernels = []          # (ts, end, name, correlation)
        self.launch = {}           # correlation → (tid, ts)
        # tid → [(ts, end, name, input dims, input types)]
        self.ops: Dict[int, List[tuple]] = {}
        for e in events:
            if e.get('ph') != 'X':
                continue
            cat = e.get('cat', '')
            ts, dur = float(e['ts']), float(e.get('dur', 0.0))
            args = e.get('args', {}) or {}
            if cat in ('kernel', 'gpu_memcpy', 'gpu_memset'):
                self.kernels.append((ts, ts + dur, e['name'],
                                     args.get('correlation')))
            elif cat == 'cuda_runtime' or cat == 'cuda_driver':
                if 'correlation' in args:
                    self.launch[args['correlation']] = (e.get('tid'), ts)
            elif cat in ('cpu_op', 'user_annotation'):
                self.ops.setdefault(e.get('tid'), []).append(
                    (ts, ts + dur, e['name'], args.get('Input Dims'),
                     args.get('Input type')))
        self.kernels.sort()
        for v in self.ops.values():
            v.sort()

    @classmethod
    def from_profiler(cls, prof, tmp: Path) -> 'Trace':
        path = tmp / 'trace.json'
        prof.export_chrome_trace(str(path))
        try:
            with open(path) as f:
                data = json.load(f)
        finally:
            path.unlink()
        events = data['traceEvents'] if isinstance(data, dict) else data
        return cls(events)

    def busy_intervals(self) -> List[tuple]:
        """The union of device activity, as sorted disjoint intervals."""
        out = []
        for ts, end, _, _ in self.kernels:
            if out and ts <= out[-1][1]:
                if end > out[-1][1]:
                    out[-1][1] = end
            else:
                out.append([ts, end])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def _op_intervals(self, pattern: str) -> Dict[int, tuple]:
        rx = re.compile(pattern)
        out = {}
        for tid, ops in self.ops.items():
            iv = sorted((s, e) for s, e, n, _, _ in ops if rx.search(n))
            merged = []
            for s, e in iv:
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            out[tid] = ([m[0] for m in merged], [m[1] for m in merged])
        return out

    def kernel_seconds(self, kernel: Optional[str] = None,
                       under: Optional[str] = None) -> float:
        """Device seconds of the kernels whose name matches `kernel`
        and/or whose host launch lies inside an op matching `under`."""
        krx = re.compile(kernel) if kernel else None
        ivs = self._op_intervals(under) if under else None
        total = 0.0
        for ts, end, name, corr in self.kernels:
            if krx is not None and not krx.search(name):
                continue
            if ivs is not None:
                tid, lts = self.launch.get(corr, (None, None))
                if tid not in ivs:
                    continue
                starts, ends = ivs[tid]
                i = bisect_right(starts, lts) - 1
                if i < 0 or lts > ends[i]:
                    continue
            total += end - ts
        return total * 1e-6

    def op_shapes(self, pattern: str) -> List[tuple]:
        """(input dims, input types) of every host op matching `pattern`."""
        rx = re.compile(pattern)
        return [(d, t) for ops in self.ops.values()
                for _, _, n, d, t in ops if rx.fullmatch(n)]

    def breakdown(self, window_us: tuple) -> Dict:
        """The 10 device ops that took most time, and the 10 longest idle
        gaps' seconds summed by what the host was doing (the innermost
        harness span and host op at the gap's middle)."""
        by = {}
        for ts, end, name, _ in self.kernels:
            short = re.sub(r'\(.*', '', name.replace(
                '(anonymous namespace)', ''))[:120]
            by[short] = by.get(short, 0.0) + (end - ts) * 1e-6
        ops = sorted(by.items(), key=lambda x: -x[1])[:10]
        busy = self.busy_intervals()
        gaps = []
        prev = window_us[0]
        for s, e in busy + [[window_us[1], window_us[1]]]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:200]
        spans = [(s, e, n[5:]) for ops in self.ops.values()
                 for s, e, n, _, _ in ops if n.startswith('span:')]
        host = {tid: ([o[0] for o in ops], ops)
                for tid, ops in self.ops.items()}
        named = {}
        for s, e in gaps:
            key = self._host_at((s + e) / 2, spans, host)
            named[key] = named.get(key, 0.0) + (e - s) * 1e-6
        idle = sorted(named.items(), key=lambda x: -x[1])[:10]
        return {'device_ops': [[n, v] for n, v in ops],
                'idle_gaps': [[n, v] for n, v in idle]}

    @staticmethod
    def _host_at(t: float, spans, host) -> str:
        """The innermost harness span and host op running at time t."""
        span, best = 'outside spans', -1.0
        for s, e, n in spans:
            if s <= t <= e and s > best:
                span, best = n, s
        op, best = '', -1.0
        for starts, ops in host.values():
            i = bisect_right(starts, t) - 1
            for j in range(i, max(i - 500, -1), -1):
                s, e, n = ops[j][0], ops[j][1], ops[j][2]
                if s <= t <= e and not n.startswith(('span:',
                                                     'ProfilerStep')):
                    if s > best:
                        op, best = n, s
                    break
        return f'{span}: {op}' if op else span


class TraceWindow:
    """A torch.profiler window, as reverb_tpu_torch/utils/profiling.py:
    ProfileWindow opens it.  The timing window (the default) traces host
    ops and the card without input shapes, whose recording costs the host
    time on every op; the shapes window (`shapes=True`) traces host ops
    with their input shapes and not the card."""

    def __init__(self, tmp: Path, shapes: bool = False):
        self.tmp = tmp
        self.shapes = shapes
        self.prof = None
        self.t0 = self.t1 = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        cuda = torch.cuda.is_available()
        card = [ProfilerActivity.CUDA] if cuda and not self.shapes else []
        self.prof = profile(activities=[ProfilerActivity.CPU] + card,
                            record_shapes=self.shapes)
        if cuda:
            torch.cuda.synchronize()
        self.prof.__enter__()
        with torch.profiler.record_function('span:window_start'):
            pass
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with torch.profiler.record_function('span:window_end'):
            pass
        self.t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        return False

    def trace(self) -> Trace:
        return Trace.from_profiler(self.prof, self.tmp)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def trace_window_us(trace: Trace) -> tuple:
    """The traced window in the trace's clock: from the start annotation
    to the end annotation."""
    start = end = None
    for ops in trace.ops.values():
        for s, e, n, _, _ in ops:
            if n == 'span:window_start':
                start = s
            elif n == 'span:window_end':
                end = e
    return start, end


# ------------------------------ launch counters --------------------------

def counter_names(cell: Cell) -> List[str]:
    """The program's launch counters (`module:ATTRIBUTE`) that the cell's
    per-layer metrics name in their `counter` parameter."""
    names = []
    for m in cell.per_layer:
        c = cell.metric_entry(m['name']).get('params', {}).get('counter')
        if c and c not in names:
            names.append(c)
    return names


def read_counters(names: List[str]) -> Dict[str, int]:
    out = {}
    for name in names:
        module, attr = name.split(':')
        out[name] = int(getattr(importlib.import_module(module), attr))
    return out


def counted(before: Dict[str, int], after: Dict[str, int]
            ) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in before}


# ------------------------------ per-layer metrics ------------------------

def read_per_layer(cell: Cell, ctx) -> Dict[str, Dict]:
    """Each per-layer metric of the cell by its reader; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        entry = cell.metric_entry(m['name'])
        reader = importlib.import_module(
            f"benchmark.readers.{entry['reader']}")
        value = reader.read(ctx, **entry.get('params', {}))
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


# ------------------------------ the result ------------------------------

def quantile(values: List[float], q: float) -> float:
    """The q-quantile of `values` (linear between order statistics)."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = q * (len(v) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (reverb_tpu_torch is not reverb_tpu)."""
    tops = {name.split('.', 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def check_lines(checks: Dict[str, Dict]) -> List[str]:
    return [f"check {k}: {v['value']!r} limit {v['limit']!r} "
            f"({'ok' if v['ok'] else 'FAILED'})" for k, v in checks.items()]


def emit(result: Dict, checks: Dict[str, Dict]):
    """The last lines of stderr: each compared number beside its limit;
    the last line of stdout: the result, its `checks` key last."""
    bad = forbidden_loaded()
    if bad:
        print(f'forbidden modules loaded in the process: {bad}',
              file=sys.stderr, flush=True)
        raise SystemExit(3)
    result = dict(result)
    result['checks'] = {k: {'value': v['value'], 'limit': v['limit']}
                        for k, v in checks.items()}
    sys.stdout.flush()
    for line in check_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def log(msg: str):
    print(f'[bench {time.strftime("%H:%M:%S")}] {msg}', file=sys.stderr,
          flush=True)
