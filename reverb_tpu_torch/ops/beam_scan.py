"""CTC prefix beam search kernels K2 (forward frame scan) and K3
(backpointer walk), with their plain PyTorch versions.

Counterpart of reverb_tpu/ops/beam_scan.py.  `beam_scan_forward` runs every
frame of `decode/prefix_beam._step` in one launch per batch: one CUDA block
of five warps per utterance, the frame inputs staged through a two-chunk
ring in shared memory (`scan_launch_plan`), three block barriers a frame,
the top-K an exact rank count.
`beam_backtrace` rebuilds the (B, K, L) token and time matrices from the
per-frame records, with the scatter-max fused in: one block per utterance
walks the records chunk by chunk in shared memory, last chunk first, and
builds the outputs there too when they fit (`backtrace_launch_plan`).  Both
take the plain version for CPU tensors and launch the kernel for CUDA
tensors (csrc/beam_scan.cu) — there is no fallback.

With `ctx_tables` (a context graph's (S, V) goto and score tables,
decode/prefix_beam.py:_graph_tables) `beam_scan_forward` launches the
biased instantiation of the scan, K2b: each extension cell gathers its
next trie state and bonus, the bonus and the beam's carried bonus enter the
pruning totals, and the final state gains `ctx` and `cum`.  The records,
and so K3, are the unbiased scan's.  JAX has no biased streaming, so a
biased call takes no `state`.

Record layout (time-leading): eight (T, B, K) int32 arrays named by
`prefix_beam.EMIT_KEYS` plus `wval` (T, B) int32, the frame index written by
a time update.  The kernel's records are views of one allocation and its
final state of another.

The scan starts from the empty prefix, or resumes from a given `state`: the
eight (B, K) arrays of `prefix_beam.STATE_KEYS`, as an earlier scan returned
them (a streaming hop carries the beam over from the hop before,
decode/streaming_beam.py).  The final state always holds all eight.  The
hashes h1/h2 are uint32 in the kernel and int64 masked to 2³² in PyTorch;
the wrapper converts both ways exactly.
"""

from __future__ import annotations

import functools

import torch

from reverb_tpu_torch import _build
from reverb_tpu_torch.decode.prefix_beam import (EMIT_KEYS, STATE_KEYS,
                                                 _backtrace, _init_state,
                                                 _step)

# kernel launches in this process (read by chip_smoke.py): K2, K2b, K3
FWD_LAUNCHES = 0
BIASED_LAUNCHES = 0
BT_LAUNCHES = 0
_MAX_K = 16
_MAX_CAND = 128
# the most shared memory a block may ask for on sm_90 (227 KB)
SMEM_MAX = 232448
_SCAN_CHUNK = 32      # frames per stage of the scan's input ring
_BT_CHUNK = 64        # frames per stage of the walk's record ring
_MASK32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=4096)
def scan_launch_plan(T: int, K: int, K2: int):
    """(chunk, smem_bytes) of the scan for T frames: the frames go through
    shared memory in ceil(T / chunk) chunks of `chunk` frames (the last may
    be short), two stages deep; a stage holds logp and idx as (chunk, 16)
    rows (a frame's K2 values, then pads), ts and blank_acc (chunk) and the
    valid and has_skip bytes, rounded up to 16 bytes.  A chunk is at most a
    warp's 32 lanes long (lane l holds frame l's blank log-prob).  The ring
    has no limit on T."""
    if not (1 <= K <= _MAX_K and 1 <= K2 <= _MAX_K
            and K * (K2 + 1) <= _MAX_CAND):
        raise ValueError(f'beam_scan_forward: K={K}, K2={K2} outside the '
                         f'kernel limits')
    chunk = max(1, min(_SCAN_CHUNK, T))
    stage = -(-chunk * (8 * _MAX_K + 10) // 16) * 16
    return chunk, 2 * stage


@functools.lru_cache(maxsize=4096)
def backtrace_launch_plan(T: int, K: int, L: int):
    """(chunk, smem_bytes, out_on_chip) of the walk: the records go through
    a two-stage ring of `chunk` frames, a stage holding the eight record
    arrays as (chunk, 16) rows and wval (chunk).  The (2, K, L) outputs are
    built in shared memory when they fit beside the ring within SMEM_MAX
    (K = 10: L up to 2080; K = 16: L up to 1300), else in place in device
    memory (the uncapped search of a long utterance)."""
    if not 1 <= K <= _MAX_K:
        raise ValueError(f'beam_backtrace: K={K} outside the kernel limits')
    chunk = max(1, min(_BT_CHUNK, T))
    ring = 2 * (8 * chunk * _MAX_K + chunk) * 4
    out = 2 * K * L * 4
    on_chip = ring + out <= SMEM_MAX
    return chunk, ring + (out if on_chip else 0), on_chip


def chunk_spans(T: int, chunk: int):
    """The [start, end) frame spans a kernel's ring covers, in order."""
    return [(t0, min(T, t0 + chunk)) for t0 in range(0, T, chunk)]


def beam_scan_forward_plain(topk_logp, topk_idx, ts, valid, blank_acc,
                            has_skip, K: int, blank_id: int, state=None,
                            ctx_tables=None):
    """The frame loop of `prefix_beam._step`, from the empty prefix or from
    `state` ({STATE_KEYS: (B, K)}), biased by `ctx_tables` (next_tab,
    score_tab) when given.  Returns (final state {STATE_KEYS (+ CTX_KEYS
    when biased): (B, K)}, emits as in the module docstring)."""
    B, T, _ = topk_logp.shape
    _check_biased(state, ctx_tables)
    state = (_init_state(B, K, topk_logp.device, ctx_tables is not None)
             if state is None else {n: state[n] for n in STATE_KEYS})
    records = []
    for t in range(T):
        state, em = _step(state, topk_logp[:, t], topk_idx[:, t], ts[:, t],
                          valid[:, t], blank_acc[:, t], has_skip[:, t], K,
                          blank_id, ctx_tables)
        records.append(em)
    dev = topk_logp.device
    emits = {n: (torch.stack([r[n] for r in records]) if T else
                 torch.zeros((0, B, K), dtype=torch.int32, device=dev))
             for n in EMIT_KEYS}
    emits['wval'] = (torch.stack([r['wval'] for r in records]) if T else
                     torch.zeros((0, B), dtype=torch.int32, device=dev))
    return state, emits


def _check_biased(state, ctx_tables):
    if state is not None and ctx_tables is not None:
        raise ValueError('beam_scan_forward: a biased scan starts from the '
                         'empty prefix (the JAX package has no biased '
                         'streaming)')


def pack_state(state: dict, B: int, K: int, device):
    """{STATE_KEYS: (B, K)} → the kernel's (8, B, K) int32 words: plen and
    last as they are, the hashes' low 32 bits, the scores' f32 bits."""
    def words(n):
        x = state[n].to(device)
        if n in ('h1', 'h2'):
            x = x.to(torch.int64) & _MASK32
            x = torch.where(x >= 2 ** 31, x - 2 ** 32, x)
        elif n in ('s', 'ns', 'v_s', 'v_ns'):
            return x.to(torch.float32).contiguous().view(torch.int32)
        return x.to(torch.int32)
    out = torch.stack([words(n) for n in STATE_KEYS])
    if out.shape != (8, B, K):
        raise ValueError(f'beam_scan_forward: state of shape '
                         f'{tuple(out.shape[1:])}, expected {(B, K)}')
    return out.contiguous()


def unpack_state(words) -> dict:
    """`pack_state`'s inverse: (8, B, K) int32 → {STATE_KEYS: (B, K)} with
    the hashes in int64 in [0, 2³²)."""
    out = {}
    for n, w in zip(STATE_KEYS, words.unbind(0)):
        if n in ('h1', 'h2'):
            out[n] = w.to(torch.int64) & _MASK32
        elif n in ('s', 'ns', 'v_s', 'v_ns'):
            out[n] = w.view(torch.float32)
        else:
            out[n] = w
    return out


def beam_backtrace_plain(emits: dict, order, final_sel_ns, L: int):
    """Reverse walk + scatter-max (`prefix_beam._backtrace`)."""
    return _backtrace(emits, order, final_sel_ns, L)


def beam_scan_forward(topk_logp, topk_idx, ts, valid, blank_acc, has_skip,
                      K: int, blank_id: int, state=None, ctx_tables=None):
    """topk_logp (B,T,K2) f32, topk_idx (B,T,K2) i32, ts (B,T) i32, valid
    and has_skip (B,T) bool, blank_acc (B,T) f32; `state` None (the empty
    prefix) or {STATE_KEYS: (B, K)}; `ctx_tables` None or (next_tab (S, V)
    i32, score_tab (S, V) f32), which launches K2b.  Returns (final, emits)
    as `beam_scan_forward_plain`."""
    global FWD_LAUNCHES, BIASED_LAUNCHES
    _check_biased(state, ctx_tables)
    if topk_logp.device.type == 'cpu':
        return beam_scan_forward_plain(topk_logp, topk_idx, ts, valid,
                                       blank_acc, has_skip, K, blank_id,
                                       state, ctx_tables)
    if topk_logp.device.type != 'cuda':
        raise RuntimeError(f'beam_scan_forward: no kernel for '
                           f'{topk_logp.device}')
    B, T, K2 = topk_logp.shape
    chunk, _ = scan_launch_plan(T, K, K2)
    want = ((topk_logp, torch.float32, (B, T, K2)),
            (topk_idx, torch.int32, (B, T, K2)), (ts, torch.int32, (B, T)),
            (valid, torch.bool, (B, T)), (blank_acc, torch.float32, (B, T)),
            (has_skip, torch.bool, (B, T)))
    dev = topk_logp.device
    for x, dt, shape in want:
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f'beam_scan_forward: expected {dt} {shape}, '
                             f'got {x.dtype} {tuple(x.shape)}')
        if x.device != dev or not x.is_contiguous():
            raise ValueError('beam_scan_forward: inputs must be contiguous '
                             'tensors of one device')
    st = None if state is None else pack_state(state, B, K, dev)
    # one allocation for the nine records, one for the final state
    n = T * B * K
    rec = torch.empty(8 * n + T * B, dtype=torch.int32, device=dev)
    biased = ctx_tables is not None
    fin = torch.empty((10 if biased else 8, B, K), dtype=torch.int32,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    next_tab = score_tab = None
    S = V = 0
    if biased:
        next_tab, score_tab = ctx_tables
        S, V = next_tab.shape
        if (next_tab.dtype != torch.int32 or score_tab.dtype != torch.float32
                or tuple(score_tab.shape) != (S, V)):
            raise ValueError('beam_scan_forward: ctx_tables must be (S, V) '
                             'int32 and float32')
        if (next_tab.device != dev or score_tab.device != dev
                or not next_tab.is_contiguous()
                or not score_tab.is_contiguous()):
            raise ValueError('beam_scan_forward: ctx_tables must be '
                             'contiguous tensors of the inputs\' device')
    rc = _build.load().reverb_beam_scan_forward(
        topk_logp.data_ptr(), topk_idx.data_ptr(), ts.data_ptr(),
        valid.data_ptr(), blank_acc.data_ptr(), has_skip.data_ptr(),
        None if st is None else st.data_ptr(),
        None if next_tab is None else next_tab.data_ptr(),
        None if score_tab is None else score_tab.data_ptr(), rec.data_ptr(),
        fin.data_ptr(), B, T, K, K2, blank_id, chunk, S, V, stream)
    _build.check(rc, 'beam_scan_forward (biased)' if biased
                 else 'beam_scan_forward')
    if biased:
        BIASED_LAUNCHES += 1
    else:
        FWD_LAUNCHES += 1
    emits = dict(zip(EMIT_KEYS, rec[:8 * n].view(8, T, B, K).unbind(0)))
    emits['wval'] = rec[8 * n:].view(T, B)
    final = unpack_state(fin[:8])
    if biased:
        final['ctx'] = fin[8]
        final['cum'] = fin[9].view(torch.float32)
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
    dev = order.device
    for t in (order, sel, emits['wval'], *(emits[n] for n in EMIT_KEYS)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError('beam_backtrace: inputs must be contiguous '
                             'tensors of one device')
    chunk, smem, on_chip = backtrace_launch_plan(T, K, L)
    out = torch.empty((2, B, K, L), dtype=torch.int32, device=dev)
    rc = _build.load().reverb_beam_backtrace(
        *(emits[n].data_ptr() for n in EMIT_KEYS + ('wval',)),
        order.data_ptr(), sel.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), B, T, K, L, chunk, smem, int(on_chip),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'beam_backtrace')
    BT_LAUNCHES += 1
    return out[0], out[1]
