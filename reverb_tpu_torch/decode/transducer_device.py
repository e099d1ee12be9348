"""Time-synchronous transducer beam search (TSD) on the device, the whole
batch in one frame loop.

Counterpart of reverb_tpu/decode/transducer_device.py (`_child_hash`,
`_merge_topk`, `tsd_device`, `tsd_device_host`).  Each utterance keeps a
static K-row hypothesis state — prefix buffers (K, L), rolling 2×32-bit
prefix hashes for the merge, scores, and the predictor's streaming state
per row — and every frame runs ``max_sym_exp`` waves: one joint over the
B·K rows, the top (beam + 1) tokens of each row, an O(N²) hash-equality
log-add merge of the children and a top-K, then a gather of the parents'
predictor states and one predictor step for the children.  The JAX
package vmaps one utterance's scan over the batch; here the batch is the
leading axis of every state tensor, and frames past an utterance's length
leave its state untouched.

The hash is the JAX package's uint32 arithmetic, in int64 masked to 2³²
(as kernel K2's).  Top-k breaks ties to the lower index, as
`jax.lax.top_k` (ops/topk.py).  Scores accumulate in f32, as in JAX.
None of it is a Pallas kernel in JAX: plain torch ops.
"""

from __future__ import annotations

from typing import List

import torch

from reverb_tpu_torch.models.transducer import (NEG_INF, Joint, Predictor,
                                                where_state)
from reverb_tpu_torch.ops.topk import topk_lastdim

_MASK32 = 0xFFFFFFFF
_MULT1, _MULT2 = 0x01000193, 0x0001003F      # FNV-ish, as prefix_beam
_SEED1, _SEED2 = 0x12345679, 0x87654321


def _child_hash(h1, h2, u):
    uu = u.to(torch.int64) + 1
    return (h1 * _MULT1 + uu) & _MASK32, (h2 * _MULT2 + uu) & _MASK32


def _merge_topk(h1, h2, scores, K: int):
    """Over the last axis of (B, N) candidates: log-add the candidates
    with equal (h1, h2) onto the first occurrence, then the top K.
    Returns (merged scores (B, K), indices (B, K))."""
    N = scores.shape[-1]
    valid = scores > NEG_INF / 2
    eq = ((h1[:, :, None] == h1[:, None, :])
          & (h2[:, :, None] == h2[:, None, :])
          & valid[:, :, None] & valid[:, None, :])
    neg = torch.full((), NEG_INF, device=scores.device)
    sc = torch.where(eq, scores[:, None, :], neg)
    m = sc.amax(2)
    ssum = torch.where(eq, torch.exp(sc - m[:, :, None]),
                       torch.zeros((), device=scores.device)).sum(2)
    merged = torch.where(valid, m + torch.log(ssum.clamp(min=1e-37)), neg)
    first = torch.argmax(eq.to(torch.int32), 2)     # first equal index
    keep = first == torch.arange(N, device=scores.device)[None, :]
    final = torch.where(keep & valid, merged, neg)
    return topk_lastdim(final, K)


def _gather(x, idx):
    """x (B, K, ...) rows idx (B, K') along axis 1."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


def _state_rows(state, idx):
    """A predictor state over B·K flat rows, rows idx (B, K') of each
    utterance."""
    B, K2 = idx.shape

    def rows(t):
        return _gather(t.reshape((B, -1) + t.shape[1:]), idx).reshape(
            (B * K2,) + t.shape[1:])
    if isinstance(state, list):
        return [(rows(h), rows(c)) for h, c in state]
    return rows(state)


@torch.no_grad()
def tsd_device(predictor: Predictor, joint: Joint, enc, enc_lens,
               beam_size: int = 4, max_sym_exp: int = 2, max_tokens: int = 0,
               score_norm: bool = True):
    """Batched TSD.  enc (B, T, D), enc_lens (B,) → (prefixes (B, K, L),
    plens (B, K), scores (B, K)) best-first (by score / length when
    score_norm, the espnet default)."""
    cfg = predictor.cfg
    B, T, _ = enc.shape
    dev = enc.device
    K = beam_size
    L = max_tokens or (T * max(max_sym_exp - 1, 1) + 1)
    blank = cfg.blank_id
    kk = min(K + 1, cfg.vocab_size)
    enc = enc.float()
    lens = enc_lens.to(dev)
    row = torch.arange(K, device=dev, dtype=torch.int64)
    active = (row == 0)[None, :].expand(B, K)
    neg = torch.full((), NEG_INF, device=dev)
    pred_out, pred_state = predictor.step(
        torch.full((B * K,), blank, dtype=torch.int64, device=dev),
        predictor.init_state(B * K, dev))
    state = dict(
        prefixes=torch.zeros((B, K, L), dtype=torch.int64, device=dev),
        plen=torch.zeros((B, K), dtype=torch.int64, device=dev),
        h1=torch.where(active, _SEED1, row + 7),
        h2=torch.where(active, _SEED2, row + 13),
        scores=torch.where(active, 0.0, neg),
        pred_out=pred_out.reshape(B, K, -1), pred_state=pred_state)
    dead1 = (101 + row)[None, :].expand(B, K)
    dead2 = (211 + row)[None, :].expand(B, K)
    pos = torch.arange(L, device=dev)
    for t in range(T):
        C = state
        a_sc, a_h1, a_h2, snaps = [], [], [], []
        for v in range(max_sym_exp):
            logits = joint(enc[:, t, None, :], C['pred_out'])    # (B, K, V)
            logp = torch.log_softmax(logits.float(), -1)
            alive = C['scores'] > NEG_INF / 2
            a_sc.append(torch.where(alive, C['scores'] + logp[..., blank],
                                    neg))
            a_h1.append(C['h1'])
            a_h2.append(C['h2'])
            snaps.append(C)
            if v == max_sym_exp - 1:
                break
            # the host takes the top (beam + 1) of the whole row and drops
            # blank: K children when blank is among them, else K + 1
            vals, idx = topk_lastdim(logp, kk)                   # (B, K, kk)
            cand = torch.where((idx == blank) | ~alive[..., None], neg,
                               C['scores'][..., None] + vals)
            ch1, ch2 = _child_hash(C['h1'][..., None], C['h2'][..., None],
                                   idx)
            flat_h1, flat_h2 = ch1.reshape(B, -1), ch2.reshape(B, -1)
            merged, sel = _merge_topk(flat_h1, flat_h2, cand.reshape(B, -1),
                                      K)
            parent = torch.div(sel, kk, rounding_mode='floor')
            tok = torch.gather(idx.reshape(B, -1), 1, sel)
            live = merged > NEG_INF / 2
            pprefix = _gather(C['prefixes'], parent)
            pplen = torch.gather(C['plen'], 1, parent)
            wpos = pos[None, None, :] == pplen.clamp(max=L - 1)[..., None]
            nprefix = torch.where(wpos & live[..., None], tok[..., None],
                                  pprefix)
            pred_out, pred_state = predictor.step(
                tok.reshape(-1), _state_rows(C['pred_state'], parent))
            C = dict(
                prefixes=nprefix,
                plen=torch.where(live, pplen + 1, pplen),
                # dead rows: distinct hashes, so that they never merge
                h1=torch.where(live, torch.gather(flat_h1, 1, sel), dead1),
                h2=torch.where(live, torch.gather(flat_h2, 1, sel), dead2),
                scores=merged, pred_out=pred_out.reshape(B, K, -1),
                pred_state=pred_state)
        # merge A across the waves (a prefix may consume the frame at
        # several depths) and keep the top K as the next frame's beam
        # (sel indexes the waves' K rows one after the other: wave v, row
        # k is v·K + k, in every snapshot tensor laid out (B, V·K, ...))
        merged, sel = _merge_topk(torch.cat(a_h1, 1), torch.cat(a_h2, 1),
                                  torch.cat(a_sc, 1), K)
        nxt = {key: _gather(torch.cat([s[key] for s in snaps], 1), sel)
               for key in ('prefixes', 'plen', 'h1', 'h2', 'pred_out')}
        nxt['scores'] = merged

        def waves(parts):
            return torch.cat([p.reshape(B, K, -1) for p in parts], 1
                             ).reshape(B * len(parts) * K, -1)
        states = [s['pred_state'] for s in snaps]
        if isinstance(states[0], list):
            nxt['pred_state'] = [
                tuple(_state_rows(waves([st[i][j] for st in states]), sel)
                      for j in range(2)) for i in range(len(states[0]))]
        else:
            nxt['pred_state'] = _state_rows(waves(states), sel)
        # frames past an utterance's length leave its state untouched
        on = t < lens                                             # (B,)
        state = {k: (where_state(on.repeat_interleave(K), nxt[k], state[k])
                     if k == 'pred_state' else
                     torch.where(on.reshape((B,) + (1,) * (nxt[k].dim() - 1)),
                                 nxt[k], state[k]))
                 for k in nxt}
    sc = state['scores']
    if score_norm:
        key = sc / state['plen'].clamp(min=1).to(torch.float32)
        key = torch.where(sc > NEG_INF / 2, key, neg)
    else:
        key = sc
    order = torch.sort(-key, dim=-1, stable=True).indices
    return (_gather(state['prefixes'], order),
            torch.gather(state['plen'], 1, order),
            torch.gather(sc, 1, order))


def tsd_device_host(predictor: Predictor, joint: Joint, enc, enc_lens,
                    beam_size: int = 4, max_sym_exp: int = 2,
                    score_norm: bool = True, max_tokens: int = 0):
    """Run `tsd_device`, fetch once, pack each utterance's hypotheses
    [(tokens, score)] best-first."""
    prefixes, plens, scores = (t.cpu().numpy() for t in tsd_device(
        predictor, joint, enc, torch.as_tensor(enc_lens), beam_size,
        max_sym_exp, max_tokens, score_norm))
    out: List[List] = []
    for b in range(prefixes.shape[0]):
        hyps = []
        for k in range(prefixes.shape[1]):
            if scores[b, k] <= NEG_INF / 2:
                continue
            n = int(plens[b, k])
            hyps.append((tuple(int(t) for t in prefixes[b, k, :n]),
                         float(scores[b, k])))
        out.append(hyps)
    return out
