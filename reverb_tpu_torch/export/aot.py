"""Export of the serving function set: the counterpart of
reverb_tpu/export/aot.py.

The served artifact set is the JAX package's three fixed-shape subgraphs:
the streaming encoder chunk step with its static ring caches
(`encoder_chunk`), the CTC activation (`ctc_activation`) and the batched
rescoring decoder (`attention_decoder`).  Each is captured with
`torch.export.export` at the JAX package's shapes and written with
`torch.export.save` as `<name>.pt2`, its weights inside (as the JAX
artifact bakes them in as constants), beside a `manifest.json` with the
JAX package's keys; `load_serialized` reads one back into a callable
module.

What a program holds: the chunk step attends through the masked route
(models/attention.py:forward_masked), not kernel K1, so the exported
encoder and decoder graphs hold one kernel, K5, as the operator
`reverb::layer_norm` (ops/layer_norm.py); everything else is aten.  A
program exported on the card launches K5 when it runs; one exported on
the CPU holds the plain LayerNorm instead (the CPU takes the plain
version before the operator).

The JAX package's `aot` format primes XLA's persistent compilation cache.
The port compiles online only its CUDA kernels (nvcc), so its
`prime_kernel_dir` builds the kernel library into a directory and runs
each subgraph once there; a serving process started with
REVERB_KERNEL_DIR set to it loads the library without building
(_build.py).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch
from torch import nn

from reverb_tpu_torch import _build
from reverb_tpu_torch.models.asr_model import forward_attention_decoder
from reverb_tpu_torch.models.ctc import ctc_logprobs
from reverb_tpu_torch.models.embedding import pe_table_on
from reverb_tpu_torch.models.encoder import CONTEXT, init_stream_caches
# the operators a loaded program calls must be registered first
from reverb_tpu_torch.ops import flash_attention as _fa  # noqa: F401
from reverb_tpu_torch.ops import layer_norm as _ln  # noqa: F401

NAMES = ('encoder_chunk', 'ctc_activation', 'attention_decoder')


class EncoderChunk(nn.Module):
    """encoder_forward_chunk: (feats (B, window, F), offset 0-d int32,
    att_cache, cnn_cache or None, cat_embs (2,)) → (ys (B, chunk, D), new
    att cache, new cnn cache)."""

    def __init__(self, encoder):
        super().__init__()
        self.encoder = encoder

    def forward(self, feats, offset, att_cache, cnn_cache, cat_embs):
        return self.encoder.forward_chunk(feats, offset, att_cache,
                                          cnn_cache, cat_embs)


class CTCActivation(nn.Module):
    """ctc_logprobs: encoder_out (B, T, D) → (B, T, V) f32 log-probs."""

    def __init__(self, ctc, blank_id: int):
        super().__init__()
        self.ctc = ctc
        self.blank_id = blank_id

    def forward(self, encoder_out):
        return ctc_logprobs(self.ctc, encoder_out, 0.0, self.blank_id)


class AttentionDecoder(nn.Module):
    """forward_attention_decoder at the model's reverse_weight: (hyps (N,
    L) int32 sos-prefixed, hyps_lens (N,) int32, encoder_out (1, T, D)) →
    (l_x, r_x) (N, L, V) f32 log-probs."""

    def __init__(self, model):
        super().__init__()
        self.decoder = model.decoder
        self.cfg = model.cfg

    def forward(self, hyps, hyps_lens, encoder_out):
        return forward_attention_decoder(self, hyps, hyps_lens, encoder_out,
                                         self.cfg.reverse_weight)


def _warm_tables(model):
    """Make the cached positional table on the model's device now: one
    first made while `torch.export` traces would be a fake tensor."""
    pe_table_on(model.cfg.encoder.output_size,
                next(model.parameters()).device)


def serving_inputs(model, chunk_size: int = 16, num_left_chunks: int = 16,
                   batch_size: int = 1, rescoring_nbest: int = 10,
                   max_hyp_len: int = 64):
    """The three subgraphs as modules with their example inputs (zeros at
    the JAX package's shapes, on the model's device), and the shape info:
    ({name: (module, args)}, {'att_cache', 'cnn_cache', 'window',
    'cache_t', 'subsampling_rate', 'right_context'})."""
    cfg = model.cfg
    ecfg = cfg.encoder
    dev = next(model.parameters()).device
    sub = ecfg.subsampling_rate
    context = CONTEXT[sub]
    window = (chunk_size - 1) * sub + context
    cache_t = chunk_size * num_left_chunks
    att0, cnn0 = init_stream_caches(ecfg, cache_t, batch_size,
                                    torch.float32, dev)
    _warm_tables(model)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    fns = {
        'encoder_chunk': (EncoderChunk(model.encoder), (
            torch.zeros((batch_size, window, ecfg.input_size), **f32),
            torch.zeros((), **i32), att0, cnn0, torch.zeros((2,), **f32))),
        'ctc_activation': (CTCActivation(model.ctc, cfg.blank_id), (
            torch.zeros((batch_size, chunk_size, ecfg.output_size),
                        **f32),)),
        'attention_decoder': (AttentionDecoder(model), (
            torch.zeros((rescoring_nbest, max_hyp_len), **i32),
            torch.ones((rescoring_nbest,), **i32),
            torch.zeros((1, cache_t, ecfg.output_size), **f32))),
    }
    return fns, {'att_cache': att0, 'cnn_cache': cnn0, 'window': window,
                 'cache_t': cache_t, 'subsampling_rate': sub,
                 'right_context': context - 1}


def export_serving_functions(model, **kwargs):
    """`torch.export.export` of the serving function set at fixed shapes
    (keyword arguments as `serving_inputs`).  Returns ({name:
    ExportedProgram}, info as `serving_inputs` plus 'inputs': {name: the
    example arguments})."""
    fns, info = serving_inputs(model, **kwargs)
    with torch.no_grad():
        programs = {name: torch.export.export(fn, args)
                    for name, (fn, args) in fns.items()}
    return programs, dict(info, inputs={name: args for name, (_, args)
                                        in fns.items()})


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix('torch.')


def serialize_serving_functions(model, out_dir: str,
                                **kwargs) -> Dict[str, str]:
    """Write the serving function set to `out_dir`: `<name>.pt2` for each
    subgraph (torch.export.save, weights inside) and `manifest.json`
    (chunk_size, num_left_chunks, batch_size, window, cache_t,
    subsampling_rate, right_context, and each input's [shape, dtype] or
    null), as reverb_tpu/export/aot.py:serialize_serving_functions writes
    it.  Returns {name: path}."""
    programs, info = export_serving_functions(model, **kwargs)
    os.makedirs(out_dir, exist_ok=True)
    paths: Dict[str, str] = {}
    meta = {'chunk_size': kwargs.get('chunk_size', 16),
            'num_left_chunks': kwargs.get('num_left_chunks', 16),
            'batch_size': kwargs.get('batch_size', 1),
            'window': info['window'], 'cache_t': info['cache_t'],
            'subsampling_rate': info['subsampling_rate'],
            'right_context': info['right_context'], 'inputs': {}}
    for name, program in programs.items():
        path = os.path.join(out_dir, f'{name}.pt2')
        torch.export.save(program, path)
        paths[name] = path
        meta['inputs'][name] = [
            [list(a.shape), _dtype_name(a.dtype)] if a is not None else None
            for a in info['inputs'][name]]
    with open(os.path.join(out_dir, 'manifest.json'), 'w') as f:
        json.dump(meta, f, indent=2)
    return paths


def load_serialized(path: str):
    """A `.pt2` written by `serialize_serving_functions` as a callable
    module (the port's operators are registered on import of this
    module)."""
    return torch.export.load(path).module()


def prime_kernel_dir(model, out_dir: str, **kwargs):
    """The `aot` format: build the kernel library into `out_dir` (the
    process loads it from there unless it has loaded one already) and run
    each serving subgraph once on the model's device.  Returns the info
    of `serving_inputs`."""
    if next(model.parameters()).device.type != 'cuda':
        raise RuntimeError('the aot format primes the CUDA kernel library: '
                           'it needs a model on a CUDA device')
    _build.build(out=out_dir)
    _build.load(out_dir)
    fns, info = serving_inputs(model, **kwargs)
    with torch.inference_mode():
        for fn, args in fns.values():
            fn(*args)
    torch.cuda.synchronize()
    return info


def scriptability_check(model) -> bool:
    """The model exports with static shapes (reverb_tpu/export/aot.py:
    scriptability_check, the reference's train-time `--jit` check):
    `decode.api.encode_and_ctc` at (1, 67) frames; raises on failure."""
    from reverb_tpu_torch.decode.api import encode_and_ctc

    class EncodeAndCTC(nn.Module):
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, feats, feats_lens, cat_embs):
            return encode_and_ctc(self.model, feats, feats_lens, cat_embs)

    dev = next(model.parameters()).device
    _warm_tables(model)
    feats = torch.zeros((1, 67, model.cfg.encoder.input_size),
                        dtype=torch.float32, device=dev)
    lens = torch.tensor([67], dtype=torch.int32, device=dev)
    cat = torch.zeros((2,), dtype=torch.float32, device=dev)
    with torch.no_grad():
        torch.export.export(EncodeAndCTC(model), (feats, lens, cat))
    return True
