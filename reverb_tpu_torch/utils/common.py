"""Sequence and mask utilities (counterpart of reverb_tpu/utils/common.py:
`subsequent_chunk_mask`, `add_optional_chunk_mask` with its training draw,
`add_sos_eos`, `th_accuracy`, the sequence reversal and the Whisper
prompt `add_whisper_tokens`), and the entry points' device rule
`resolve_device`."""

from __future__ import annotations

import numpy as np
import torch

IGNORE_ID = -1


def resolve_device(device) -> torch.device:
    """The requested device; CUDA without a card raises (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    return dev


def reverse_sequence(ys_pad, ys_lens, pad_value: int = IGNORE_ID):
    """Reverse each row's first `len` elements of (B, L) ys_pad, or along
    time of a (B, T, D) stream; positions >= len get pad_value."""
    B, L = ys_pad.shape[:2]
    idx = torch.arange(L, device=ys_pad.device)[None, :]
    seq_mask = idx < ys_lens[:, None]
    gather = torch.where(seq_mask, ys_lens[:, None] - 1 - idx,
                         torch.zeros_like(idx)).to(torch.int64)
    if ys_pad.dim() == 3:
        gather = gather[:, :, None].expand(-1, -1, ys_pad.shape[2])
        seq_mask = seq_mask[:, :, None]
    rev = torch.gather(ys_pad, 1, gather)
    return torch.where(seq_mask, rev, torch.full_like(rev, pad_value))


def add_sos_eos(ys_pad, ys_lens, sos: int, eos: int,
                ignore_id: int = IGNORE_ID):
    """(B, L) ys_pad padded with ignore_id → (ys_in (B, L+1): sos then the
    tokens, padded with eos; ys_out (B, L+1): the tokens then eos, padded
    with ignore_id)."""
    B, L = ys_pad.shape
    sos_col = torch.full((B, 1), sos, dtype=ys_pad.dtype,
                         device=ys_pad.device)
    body = torch.where(ys_pad == ignore_id, torch.full_like(ys_pad, eos),
                       ys_pad)
    ys_in = torch.cat([sos_col, body], 1)
    idx = torch.arange(L + 1, device=ys_pad.device)[None, :]
    ys_body = torch.cat([ys_pad, torch.full((B, 1), ignore_id,
                                            dtype=ys_pad.dtype,
                                            device=ys_pad.device)], 1)
    lens = ys_lens[:, None]
    ys_out = torch.where(idx == lens, torch.full_like(ys_body, eos),
                         torch.where(idx < lens, ys_body,
                                     torch.full_like(ys_body, ignore_id)))
    return ys_in, ys_out


def th_accuracy(pred, gold, ignore_label: int = IGNORE_ID, denom=None):
    """Token accuracy of (B, L, V) logits against (B, L) labels, padding
    masked out; an f32 scalar tensor.  `denom` replaces the count of the
    labels (a larger batch's, of which this one is a part)."""
    mask = gold != ignore_label
    num = ((pred.argmax(-1) == gold) & mask).sum()
    if denom is not None:
        return num.to(torch.float32) / float(max(denom, 1))
    den = torch.clamp(mask.sum(), min=1)
    return num.to(torch.float32) / den.to(torch.float32)


def subsequent_chunk_mask(size: int, chunk_size, num_left_chunks=-1,
                          device=None):
    """(size, size) bool chunk-causal mask: position i sees columns
    [max((i // chunk_size − num_left_chunks)·chunk_size, 0),
    min((i // chunk_size + 1)·chunk_size, size)), from column 0 when
    num_left_chunks < 0.  `chunk_size` and `num_left_chunks` are ints or
    0-dim tensors on `device` (a drawn chunk, read without a host sync)."""
    row = torch.arange(size, device=device)
    chunk_idx = row // chunk_size
    ending = torch.clamp((chunk_idx + 1) * chunk_size, max=size)
    num_left = torch.as_tensor(num_left_chunks, device=device)
    start = torch.where(num_left < 0, torch.zeros_like(row),
                        torch.clamp((chunk_idx - num_left) * chunk_size,
                                    min=0))
    col = torch.arange(size, device=device)[None, :]
    return (col >= start[:, None]) & (col < ending[:, None])


def dynamic_chunk_from_draws(size: int, raw_chunk, raw_left,
                             use_dynamic_left_chunk: bool,
                             enable_full_context: bool = True):
    """(chunk, num_left) from the two raw draws of dynamic-chunk training
    (0-dim integer tensors), with the JAX package's arithmetic
    (reverb_tpu/utils/common.py:103-116): raw_chunk in [1, max(size, 2)) →
    the full context (chunk = size) when enable_full_context and
    raw_chunk > size // 2, else raw_chunk % 25 + 1; raw_left in [0, 2^30)
    → num_left = raw_left % max((size − 1) // chunk, 1) with
    use_dynamic_left_chunk, else −1 (all history)."""
    full = (raw_chunk > size // 2) & enable_full_context
    chunk = torch.where(full, torch.full_like(raw_chunk, size),
                        raw_chunk % 25 + 1)
    if not use_dynamic_left_chunk:
        return chunk, torch.full_like(chunk, -1)
    max_left = torch.clamp((size - 1) // torch.clamp(chunk, min=1), min=1)
    return chunk, raw_left % max_left


def draw_dynamic_chunk(size: int, generator: torch.Generator,
                       use_dynamic_left_chunk: bool,
                       enable_full_context: bool = True):
    """The training draw of a dynamic chunk: two raw draws from
    `generator` (on its device, no host read), then
    `dynamic_chunk_from_draws`.  Returns (chunk, num_left) as 0-dim int64
    tensors.  In a sharded step every data rank takes data rank 0's draw,
    as JAX draws one chunk for the global batch."""
    from reverb_tpu_torch.parallel import global_batch as gb
    dev = generator.device
    raw_chunk = torch.randint(1, max(size, 2), (), generator=generator,
                              device=dev)
    raw_left = torch.randint(0, 2 ** 30, (), generator=generator, device=dev)
    # one draw for the global batch (data rank 0's) in a sharded step
    raw_chunk, raw_left = gb.draw(torch.stack([raw_chunk, raw_left]))
    return dynamic_chunk_from_draws(size, raw_chunk, raw_left,
                                    use_dynamic_left_chunk,
                                    enable_full_context)


def add_optional_chunk_mask(masks, use_dynamic_chunk: bool,
                            use_dynamic_left_chunk: bool,
                            decoding_chunk_size: int, static_chunk_size: int,
                            num_decoding_left_chunks: int, generator=None,
                            enable_full_context: bool = True):
    """The pad mask (B, 1, T) combined with the chunk mask the flags ask
    for: (B, T, T) in the chunked cases, the pad mask itself otherwise.
    With `use_dynamic_chunk` and decoding_chunk_size 0 (training) the chunk
    is drawn from `generator` (`draw_dynamic_chunk`); without one it
    raises, as the JAX package asserts an rng there."""
    size = masks.shape[-1]
    if use_dynamic_chunk:
        if decoding_chunk_size < 0:
            return masks & torch.ones((1, size, size), dtype=torch.bool,
                                      device=masks.device)
        if decoding_chunk_size > 0:
            return masks & subsequent_chunk_mask(
                size, decoding_chunk_size, num_decoding_left_chunks,
                masks.device)[None]
        if generator is None:
            raise ValueError('dynamic chunk training needs a generator (the '
                             'JAX package asserts an rng here)')
        chunk, num_left = draw_dynamic_chunk(
            size, generator, use_dynamic_left_chunk, enable_full_context)
        return masks & subsequent_chunk_mask(size, chunk.to(masks.device),
                                             num_left.to(masks.device),
                                             masks.device)[None]
    if static_chunk_size > 0:
        return masks & subsequent_chunk_mask(
            size, static_chunk_size, num_decoding_left_chunks,
            masks.device)[None]
    return masks


# Whisper's language order (openai/whisper languages.py); a language's
# token id is sot + 1 + its index here
WHISPER_LANGS = (
    'en', 'zh', 'de', 'es', 'ru', 'ko', 'fr', 'ja', 'pt', 'tr', 'pl', 'ca',
    'nl', 'ar', 'sv', 'it', 'id', 'hi', 'fi', 'vi', 'he', 'uk', 'el', 'ms',
    'cs', 'ro', 'da', 'hu', 'ta', 'no', 'th', 'ur', 'hr', 'bg', 'lt', 'la',
    'mi', 'ml', 'cy', 'sk', 'te', 'fa', 'lv', 'bn', 'sr', 'az', 'sl', 'kn',
    'et', 'mk', 'br', 'eu', 'is', 'hy', 'ne', 'mn', 'bs', 'kk', 'sq', 'sw',
    'gl', 'mr', 'pa', 'si', 'km', 'sn', 'yo', 'so', 'af', 'oc', 'ka', 'be',
    'tg', 'sd', 'gu', 'am', 'yi', 'lo', 'uz', 'fo', 'ht', 'ps', 'tk', 'nn',
    'mt', 'sa', 'lb', 'my', 'bo', 'tl', 'mg', 'as', 'tt', 'haw', 'ln', 'ha',
    'ba', 'jw', 'su')


def add_whisper_tokens(special_tokens, ys_pad, ignore_id: int, tasks, langs,
                       no_timestamp: bool = True):
    """Whisper's multitask prompt on the host (reverb_tpu/utils/common.py:
    add_whisper_tokens): each row's tokens (ignore_id padding dropped)
    after [sot, language, task, no_timestamps (transcribe and translate)]
    and before eot.  Returns (ys_in, ys_out) int32 numpy arrays padded with
    eot and ignore_id.  tasks in {transcribe, translate, vad}; timestamped
    targets raise NotImplementedError, as there."""
    ys_pad = np.asarray(ys_pad)
    B = ys_pad.shape[0]
    assert len(tasks) == B and len(langs) == B
    ins, outs = [], []
    for b in range(B):
        task = tasks[b]
        if task in ('transcribe', 'translate'):
            task_id = special_tokens[task]
        elif task == 'vad':
            task_id = special_tokens['no_speech']
        else:
            raise NotImplementedError(f'unsupported task {task}')
        prefix = [special_tokens['sot'],
                  special_tokens['sot'] + 1 + WHISPER_LANGS.index(langs[b]),
                  task_id]
        if task in ('transcribe', 'translate'):
            if not no_timestamp:
                raise NotImplementedError('timestamped whisper targets')
            prefix.append(special_tokens['no_timestamps'])
        y = ys_pad[b][ys_pad[b] != ignore_id]
        ins.append(np.concatenate([prefix, y]))
        outs.append(np.concatenate([prefix[1:], y, [special_tokens['eot']]]))
    L = max(len(y) for y in ins)
    ys_in = np.full((B, L), special_tokens['eot'], np.int32)
    ys_out = np.full((B, L), ignore_id, np.int32)
    for b in range(B):
        ys_in[b, :len(ins[b])] = ins[b]
        ys_out[b, :len(outs[b])] = outs[b]
    return ys_in, ys_out
