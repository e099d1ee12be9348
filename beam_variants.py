#!/usr/bin/env python3
"""Where a frame of the prefix-beam scan kernel (K2) spends its time, on one
CUDA card.

    python3 beam_variants.py              # knock-out variants, timed
    python3 beam_variants.py --cycles     # + a cycle breakdown per stage

Run from the root of a checkout, on a machine with a card and nvcc.  The
card's profilers for single kernels are not always available, so this
script asks the kernel itself.  It builds reverb_tpu_torch/csrc/beam_scan.cu
as it is ("base") and once per variant in VARIANTS — each a copy of the
source with one stage cut out or moved, so most variants compute WRONG
records and are for timing only — and times every build at B = 8, K = K2 =
10 and T = 512 (dense), 256 and 128 (as a blank-skip 0.95 call passes
them): ms per call (CUDA events) and on the device alone (profiler), with
whether the outputs still equal the base's.  The difference to the base is
what the stage costs inside the frame's dependent chain.

--cycles also builds a copy in which lane 0 of warp 0 and of the keep warp
of block 0 read clock64() at each stage boundary, and prints cycles per
frame by stage.  Each reading adds about 130 cycles to the stage it ends,
so compare stages, not totals.

Builds go to _chipwork/variants/ (ignored by git).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / 'reverb_tpu_torch' / 'csrc' / 'beam_scan.cu'
OUT = ROOT / '_chipwork' / 'variants'


def _cut(src: str, start: str, end: str, new: str = '') -> str:
    """src with the text from `start` up to (not including) `end` replaced
    by `new`; both markers must be in the source."""
    a = src.index(start)
    return src[:a] + new + src[src.index(end, a):]


def _swap(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f'marker not in the source: {old!r}')
    return src.replace(old, new)


def no_rank(src):
    """No rank count: the candidate at flat index p gets rank p."""
    return _cut(src, '        const int kq = tid & 3;\n',
                '        if (tid < NC && rank < K) sel[rank] = rk_code;',
                '        const int rank = tid;\n')


def no_match(src):
    """No search of the keep prefixes that equal an extension."""
    return _cut(src, '#pragma unroll\n        for (int i = 0; i < MAXK; ++i) '
                '{\n          const uint2 hi = st.h[i];',
                '        mbits = dead ? 0u : (mbits & live_mask);')


def no_log_add(src):
    """fmaxf in place of the two chained log_adds of a cell."""
    s = _swap(src, 'const float mrg_ns = log_add(ext_ns, mrg_kns);',
              'const float mrg_ns = fmaxf(ext_ns, mrg_kns);')
    return _swap(s, 'const float tot = log_add(mrg_s, mrg_ns);',
                 'const float tot = fmaxf(mrg_s, mrg_ns);')


def no_last_token_search(src):
    """No search of the frame's tokens for a beam's last token."""
    return _cut(src, '#pragma unroll\n        for (int j = 0; j < MAXK; j += '
                '4) {\n          const float4 p4 = *reinterpret_cast<const '
                'float4*>(f_lp + j);',
                '        const bool pb_dead = p_blank <= NEG_INF;',
                '        p_last = f_lp[0] + (float)r_last;\n')


def no_record_stores(src):
    """No record is written."""
    return _swap(src, 'if (warp == SCAN_NW - 1) {', 'if (warp == 99) {')


def records_from_warp0(src):
    """Warp 0 writes the records instead of the keep warp (same outputs)."""
    return _swap(src, 'if (warp == SCAN_NW - 1) {', 'if (warp == 0) {')


VARIANTS = {f.__name__: f for f in (
    no_rank, no_match, no_log_add, no_last_token_search, no_record_stores,
    records_from_warp0)}

STAGES = ('fold', 'cells', 'barriers 1-2', 'rank', 'barrier 3', 'rebuild')
_PROF = '''
__device__ long long g_prof[32];
#define PROF(i) do { if ((tid & 31) == 0 && blockIdx.x == 0 && \\
    (warp == 0 || warp == SCAN_NW - 1)) { long long now_ = clock64(); \\
    g_prof[(warp ? 16 : 0) + (i)] += now_ - last_; last_ = now_; } } while (0)
'''
_PROF_READ = '''
extern "C" int variants_read_cycles(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * 32);
}
extern "C" int variants_zero_cycles() {
  long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
'''


def with_cycle_counters(src):
    """The source with clock64() read at the six stage boundaries of a
    frame (STAGES) by lane 0 of warp 0 and of the keep warp of block 0."""
    s = _swap(src, 'namespace {\n', 'namespace {\n' + _PROF)
    s = _swap(s, '    for (int tl = 0; tl < n; ++tl) {\n',
              '    long long last_ = clock64();\n'
              '    for (int tl = 0; tl < n; ++tl) {\n')
    s = _swap(s, '      const unsigned live_mask = __ballot_sync(0xffffffffu, '
              'live);\n      __syncwarp();\n',
              '      const unsigned live_mask = __ballot_sync(0xffffffffu, '
              'live);\n      __syncwarp();\n      PROF(0);\n')
    s = _swap(s, '      if (lane == 0 && mbits) atomicOr(mflag, mbits);\n',
              '      if (lane == 0 && mbits) atomicOr(mflag, mbits);\n'
              '      PROF(1);\n')
    s = _swap(s, '      __syncthreads();  // (2) the candidates are final\n',
              '      __syncthreads();  // (2) the candidates are final\n'
              '      PROF(2);\n')
    s = _swap(s, '      __syncthreads();  // (3) the K winners are chosen\n',
              '      PROF(3);\n'
              '      __syncthreads();  // (3) the K winners are chosen\n'
              '      PROF(4);\n')
    s = _swap(s, '        st.h[lane] = n_h;\n      }\n      __syncwarp();\n',
              '        st.h[lane] = n_h;\n      }\n      __syncwarp();\n'
              '      PROF(5);\n')
    return s + _PROF_READ


def build(name: str, src: str):
    """(library handle, registers of the scan kernel) of `src` compiled
    into OUT/name.so with the package's nvcc flags."""
    from reverb_tpu_torch import _build
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f'{name}.cu', OUT / f'{name}.so'
    cu.write_text(src)
    res = subprocess.run([_build._nvcc(), *_build._FLAGS, '-shared', '-o',
                          str(so), str(cu)], capture_output=True, text=True,
                         check=False)
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed on variant {name}:\n'
                           f'{res.stderr[-3000:]}')
    regs = re.search(r'beam_scan_kernel.*?Used (\d+) registers', res.stderr,
                     re.S)
    lib = ctypes.CDLL(str(so))
    lib.reverb_beam_scan_forward.argtypes = _build._SIGNATURES[
        'reverb_beam_scan_forward']
    return lib, int(regs.group(1)) if regs else -1


def run_scan(lib, args):
    """One launch of lib's scan on the wrapper's arguments; returns the
    packed (records, finals) buffers."""
    import torch
    from reverb_tpu_torch.ops import beam_scan as bs
    lp, ix, ts, valid, acc, hs, K, blank = args
    B, T, K2 = lp.shape
    chunk, _ = bs.scan_launch_plan(T, K, K2)
    n = T * B * K
    rec = torch.empty(8 * n + T * B, dtype=torch.int32, device=lp.device)
    fin = torch.empty((8, B, K), dtype=torch.int32, device=lp.device)
    rc = lib.reverb_beam_scan_forward(
        lp.data_ptr(), ix.data_ptr(), ts.data_ptr(), valid.data_ptr(),
        acc.data_ptr(), hs.data_ptr(), None, None, None, rec.data_ptr(),
        fin.data_ptr(), B, T, K, K2, blank, chunk, 0, 0,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f'beam_scan_forward: CUDA error {rc} at launch')
    return rec, fin


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--cycles', action='store_true',
                    help='also print a cycle breakdown of the base build')
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print('beam_variants.py: torch.cuda.is_available() is False',
              file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device('cuda', 0)
    print(f'device: {cs.smi_line()}', flush=True)
    src = SOURCE.read_text()
    inputs = {T: v[0] for T, v in cs.ab_beam_inputs(dev, cs.SEED).items()}
    builds = {'base': src, **{n: f(src) for n, f in VARIANTS.items()}}
    base, _ = build('base', src)
    want = {T: run_scan(base, a) for T, a in inputs.items()}
    torch.cuda.synchronize()
    for name, text in builds.items():
        lib, regs = build(name, text)
        cells = []
        for T, a in inputs.items():
            got = run_scan(lib, a)
            torch.cuda.synchronize()
            same = torch.equal(got[0], want[T][0]) and torch.equal(
                got[1], want[T][1])
            ms, dev_ms = cs.both_times(lambda: run_scan(lib, a), 10,
                                       cs.KERNEL_PATTERNS['K2'])
            cells.append(f'T={T}: {ms:.4f} / {dev_ms:.4f} ms '
                         f'({"same" if same else "other"} outputs)')
        print(f'{name} ({regs} registers), per call / on the device: '
              + '; '.join(cells), flush=True)
    if args.cycles:
        lib, _ = build('cycles', with_cycle_counters(src))
        for T, a in inputs.items():
            lib.variants_zero_cycles()
            run_scan(lib, a)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * 32)()
            lib.variants_read_cycles(buf)
            for label, off in (('warp 0', 0), ('keep warp', 16)):
                per = [buf[off + i] / T for i in range(len(STAGES))]
                print(f'cycles a frame, T={T}, {label}: '
                      + ', '.join(f'{s} {c:.0f}' for s, c in zip(STAGES, per))
                      + f' = {sum(per):.0f}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
