"""ReverbASR product API on PyTorch: load config + checkpoint, transcribe
long-form audio.

Counterpart of reverb_tpu/cli/reverb.py (`ReverbASR`, `load_model`,
`feats_batcher`, `transcribe_modes`, `get_output`) with the same defaults
(chunk_size=2051, beam_size=10, ctc_weight=0.1, verbatimicity=1.0,
timings_adjustment=230 ms) and the same txt/CTM bytes, plus an explicit
`device`; `quantize='int8'` serves the int8 model (ops/quant.py), as
there.  The device defaults to 'cuda' and is never swapped silently:
asking for CUDA on a machine without it raises.  `data_parallel=N` serves
with N model replicas, on cuda:0..N-1 (or the first N of `devices`): each
chunk batch is padded to a multiple of N with zero-length rows, each
replica decodes its block of rows, and the results come back in order
without the padded rows, as reverb_tpu/cli/reverb.py shards the batch
over its 'data' mesh.  Every decode mode of the
reference runs (decode/api.py), with the chunk arguments handed to the
encoder as there; incremental streaming is cli/model.py:StreamingASR and
cli/stream_pool.py:MultiStreamASR.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import math
from concurrent.futures import ThreadPoolExecutor
from itertools import chain
from pathlib import Path
from typing import Dict, Generator, List, Optional, Tuple

import numpy as np
import torch

from reverb_tpu_torch.convert import load_flat_checkpoint, state_dict_from_jax
from reverb_tpu_torch.decode.align import (adjust_model_time_offset,
                                           ctc_align, hyps_to_ctm,
                                           hyps_to_txt)
from reverb_tpu_torch.decode.api import decode as decode_modes_fn
from reverb_tpu_torch.decode.results import DecodeResult
from reverb_tpu_torch.frontend.audio import load_for_asr
from reverb_tpu_torch.frontend.cmvn import load_cmvn
from reverb_tpu_torch.frontend.fbank import (FbankConfig, compute_fbank,
                                             num_frames)
from reverb_tpu_torch.models.asr_model import (ASRModel, ModelConfig,
                                               build_model,
                                               quantize_model_int8)
from reverb_tpu_torch.text.tokenizer import init_tokenizer
from reverb_tpu_torch.utils.common import resolve_device
from reverb_tpu_torch.utils.config import load_config

_FRAME_DOWNSAMPLING_FACTOR = {'linear': 1, 'conv2d': 4, 'conv2d6': 6,
                              'conv2d8': 8}


def get_blank_id(configs, symbol_table):
    """blank from ctc_conf, else '<blank>' in the symbol table, else 0."""
    ctc_conf = configs.get('ctc_conf', {}) or {}
    if 'ctc_blank_id' in ctc_conf:
        blank_id = ctc_conf['ctc_blank_id']
        if '<blank>' in symbol_table and symbol_table['<blank>'] != blank_id:
            raise ValueError('ctc_blank_id disagrees with <blank> in the '
                             'symbol table')
    else:
        blank_id = symbol_table.get('<blank>', 0)
    configs.setdefault('ctc_conf', {})['ctc_blank_id'] = blank_id
    return configs, blank_id


class ReverbASR:
    def __init__(self, config: str, checkpoint: str,
                 cmvn_path: Optional[str] = None,
                 tokenizer_symbols: Optional[str] = None,
                 bpe_path: Optional[str] = None,
                 compute_dtype: str = 'float32',
                 quantize: str = 'none',
                 device='cuda', data_parallel: int = 0, devices=None):
        if compute_dtype not in ('float32', 'bfloat16'):
            raise ValueError(f'compute_dtype {compute_dtype!r}')
        if quantize not in ('none', 'int8'):
            raise ValueError(f'quantize {quantize!r} (none|int8)')
        replicas = _replica_devices(data_parallel, devices)
        if replicas:
            device = replicas[0]
        self.checkpoint = checkpoint
        configs = load_config(config)
        cm = configs.setdefault('cmvn_conf', {})
        if 'cmvn_file' in cm or cmvn_path:
            cm['cmvn_file'] = self._abspath(cm.get('cmvn_file'), cmvn_path)
        tk = configs.setdefault('tokenizer_conf', {})
        tk['symbol_table_path'] = self._abspath(
            tk.get('symbol_table_path'), tokenizer_symbols)
        if 'bpe_path' in tk or bpe_path:
            tk['bpe_path'] = self._abspath(tk.get('bpe_path'), bpe_path)
        tokenizer = init_tokenizer(configs)
        configs, _ = get_blank_id(configs, tokenizer.symbol_table)
        configs['output_dim'] = len(tokenizer.symbol_table)
        cfg = ModelConfig.from_config(configs)
        dev = resolve_device(device)
        flat = load_flat_checkpoint(checkpoint)
        cmvn_file = configs.get('cmvn_conf', {}).get('cmvn_file')
        if 'encoder.global_cmvn.mean' not in flat and cmvn_file:
            mean, istd = load_cmvn(
                cmvn_file, configs['cmvn_conf'].get('is_json_cmvn', True))
            flat['encoder.global_cmvn.mean'] = mean
            flat['encoder.global_cmvn.istd'] = istd
        if compute_dtype == 'bfloat16':
            cfg = cfg.with_compute_dtype(torch.bfloat16)
        model = build_model(cfg, dev, state_dict_from_jax(flat))
        if quantize == 'int8':
            # serving PTQ: per-channel int8 weights, dynamic per-token int8
            # activations, int32 products (ops/quant.py)
            model = quantize_model_int8(model)
        self._setup(configs, model, tokenizer)
        self._replicate(replicas)

    @classmethod
    def from_model(cls, configs: Dict, model: ASRModel, tokenizer,
                   data_parallel: int = 0, devices=None):
        """A ReverbASR around an in-memory model (its device and dtype are
        the model's; with `data_parallel` it must sit on the first of the
        replicas' devices)."""
        self = cls.__new__(cls)
        self.checkpoint = None
        self._setup(configs, model, tokenizer)
        self._replicate(_replica_devices(data_parallel, devices))
        return self

    def _replicate(self, devices):
        """The replicas of data-parallel serving: the model, and a copy
        of it (built, quantized) on each further device."""
        if not devices:
            return
        if devices[0] != self.device:
            raise ValueError(f'the model is on {self.device}, the first '
                             f'replica on {devices[0]}')
        self.replicas = [self.model] + [copy.deepcopy(self.model).to(d)
                                        for d in devices[1:]]

    def _setup(self, configs, model, tokenizer):
        self.configs = configs
        self.model = model
        self.replicas = [model]
        self.tokenizer = tokenizer
        self.device = next(model.parameters()).device
        self.test_conf = configs.get('dataset_conf', {}) or {}
        fbank_conf = self.test_conf.get('fbank_conf', {}) or {}
        self.fbank = FbankConfig(
            num_mel_bins=fbank_conf.get('num_mel_bins', 80),
            frame_length_ms=fbank_conf.get('frame_length', 25),
            frame_shift_ms=fbank_conf.get('frame_shift', 10))
        self.input_frame_length = self.fbank.frame_shift_ms
        self.output_frame_length = (
            self.input_frame_length * _FRAME_DOWNSAMPLING_FACTOR.get(
                configs.get('encoder_conf', {}).get('input_layer', 'conv2d'),
                4))

    def _abspath(self, config_path, alternate=None):
        if alternate:
            return str(alternate)
        if config_path is None:
            return None
        p = Path(config_path)
        if not p.is_absolute():
            p = Path(self.checkpoint).parent / p
        return p.as_posix()

    # ------------------------------ features ------------------------------

    def compute_feats(self, audio_file: str, resample_rate: int = 16000):
        """Full-file fbank (T, M) on the model's device."""
        wave = load_for_asr(audio_file, resample_rate)
        T = num_frames(len(wave), self.fbank)
        return compute_fbank(torch.from_numpy(wave).to(self.device),
                             self.fbank, n_frames=T)

    def feats_batcher(self, feats, chunk_size: int, batch_size: int
                      ) -> Generator[Tuple[torch.Tensor, np.ndarray], None,
                                     None]:
        """Split (T, M) features into (B, chunk_size, M) batches, zero-padding
        the final chunk."""
        T, M = feats.shape
        per_batch = chunk_size * batch_size
        n_batches = max(math.ceil(T / per_batch), 1)
        for b in range(n_batches):
            part = feats[b * per_batch:(b + 1) * per_batch]
            bs = batch_size if b < n_batches - 1 else \
                max(math.ceil(part.shape[0] / chunk_size), 1)
            lens = np.full((bs,), chunk_size, dtype=np.int32)
            pad = bs * chunk_size - part.shape[0]
            if pad > 0:
                lens[-1] = chunk_size - pad
                part = torch.nn.functional.pad(part, (0, 0, 0, pad))
            yield part.reshape(bs, chunk_size, M), lens

    # ------------------------------ transcribe ------------------------------

    def transcribe_modes(self, audio_file, modes: List[str],
                         format: str = 'txt',
                         verbatimicity: float = 1.0,
                         chunk_size: int = 2051,
                         batch_size: Optional[int] = None,
                         beam_size: int = 10,
                         decoding_chunk_size: int = -1,
                         num_decoding_left_chunks: int = -1,
                         ctc_weight: float = 0.1,
                         simulate_streaming: bool = False,
                         reverse_weight: float = 0.0,
                         blank_penalty: float = 0.0,
                         length_penalty: float = 0.0,
                         timings_adjustment: float = 230,
                         blank_skip_threshold: float = 0.0,
                         context_graph=None) -> List[str]:
        """One output string per mode.  The streaming arguments are the
        JAX package's: `decoding_chunk_size` reaches the encoder (a chunk
        mask on a use_dynamic_chunk model), `num_decoding_left_chunks` is
        passed to `decode`, which does not use it, and `simulate_streaming`
        is accepted with no effect, as reverb_tpu/cli/reverb.py accepts it.
        `context_graph` (decode/context_graph.ContextGraph) biases the
        prefix beam in-beam."""
        feats = self.compute_feats(audio_file)
        if not batch_size:
            # all of a file's chunks in one batch, capped to bound memory
            # (per replica)
            batch_size = min(max(math.ceil(feats.shape[0] / chunk_size), 1),
                             8 * len(self.replicas))
        cat_embs = np.asarray([verbatimicity, 1.0 - verbatimicity],
                              dtype=np.float32)
        kwargs = dict(beam_size=beam_size, ctc_weight=ctc_weight,
                      reverse_weight=reverse_weight,
                      blank_penalty=blank_penalty,
                      length_penalty=length_penalty,
                      decoding_chunk_size=decoding_chunk_size,
                      num_decoding_left_chunks=num_decoding_left_chunks,
                      cat_embs=torch.from_numpy(cat_embs),
                      blank_skip_threshold=blank_skip_threshold,
                      context_graph=context_graph)
        results = []
        for feats_batch, feats_lens in self.feats_batcher(
                feats, chunk_size, batch_size):
            results.append(self._decode_rows(modes, feats_batch,
                                             torch.from_numpy(feats_lens),
                                             kwargs))
        return [self.get_output(format, Path(audio_file).name,
                                list(chain(*(r[mode] for r in results))),
                                timings_adjustment, chunk_size)
                for mode in modes]

    def _decode_rows(self, modes, feats_batch, feats_lens, kwargs):
        """decode_modes_fn of one chunk batch, its rows split over the
        replicas (padded to a multiple of their count with zero-length
        rows, which are dropped from the results), one thread a replica:
        on cards each replica's host work overlaps the others' kernels."""
        n = len(self.replicas)
        rows = feats_batch.shape[0]
        pad = -rows % n
        if pad:
            feats_batch = torch.nn.functional.pad(feats_batch,
                                                  (0, 0, 0, 0, 0, pad))
            feats_lens = torch.nn.functional.pad(feats_lens, (0, pad))
        per = feats_batch.shape[0] // n

        def run(i):
            model = self.replicas[i]
            dev = next(model.parameters()).device
            with torch.cuda.device(dev) if dev.type == 'cuda' else \
                    contextlib.nullcontext():
                return decode_modes_fn(
                    model, modes, feats_batch[i * per:(i + 1) * per].to(dev),
                    feats_lens[i * per:(i + 1) * per], **kwargs)
        with ThreadPoolExecutor(n) as pool:
            parts = list(pool.map(run, range(n)))
        return {m: list(chain(*(p[m] for p in parts)))[:rows]
                for m in modes}

    def transcribe(self, audio_file, mode: str = 'ctc_prefix_beam_search',
                   **kwargs) -> str:
        return self.transcribe_modes(audio_file, [mode], **kwargs)[0]

    def get_output(self, format: str, audio_name: str,
                   hyps: List[DecodeResult], timings_adjustment_ms: float,
                   chunk_size: int) -> str:
        """Per-chunk word alignment + time re-offset."""
        def id_to_token(tid):
            return self.tokenizer.detokenize([tid])[1][0]

        if format == 'txt':
            fmt, delim = hyps_to_txt, ' '
        elif format == 'ctm':
            fmt, delim = (lambda p: hyps_to_ctm(audio_name, p)), '\n'
        else:
            raise ValueError('Invalid output format.')
        out = []
        time_shift_ms = 0
        for hyp in hyps:
            times = hyp.times if hyp.times is not None else \
                list(range(len(hyp.tokens)))
            path = ctc_align(hyp.tokens, times, hyp.tokens_confidence,
                             id_to_token, self.output_frame_length,
                             time_shift_ms)
            path = adjust_model_time_offset(path, timings_adjustment_ms)
            time_shift_ms += chunk_size * self.input_frame_length
            out.extend(fmt(path))
        return delim.join(out)


def _replica_devices(data_parallel: int, devices) -> List[torch.device]:
    """The N devices of data-parallel serving ([] for N = 0): the first N
    of `devices`, else cuda:0..N-1.  N above the devices there are
    raises."""
    if not data_parallel:
        return []
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f'cuda:{i}' for i in range(count)]
    if data_parallel > len(devices):
        raise ValueError(f'data_parallel={data_parallel} needs as many '
                         f'devices; {len(devices)} available')
    return [resolve_device(d) for d in devices[:data_parallel]]


def load_model(model: str, **kwargs) -> ReverbASR:
    """Load a local model directory (config.yaml + *.npz / *.pt)."""
    model_dir = Path(model)
    if not model_dir.is_dir():
        raise ValueError(f'{model!r} is not a model directory (config.yaml '
                         f'+ checkpoint); downloading is not supported')
    config_path = (model_dir / 'config.yaml').resolve()
    ckpts = sorted(model_dir.glob('*.npz')) + sorted(model_dir.glob('*.pt'))
    if not ckpts:
        raise FileNotFoundError(f'no checkpoint (*.pt/*.npz) in {model_dir}')
    logging.info('Loading model: config=%s checkpoint=%s', config_path,
                 ckpts[0])
    return ReverbASR(str(config_path), str(ckpts[0]), **kwargs)
