"""Diarization inference: audio files → one RTTM per file.

Counterpart of reverb_tpu/bin/infer_diarization.py, with its flags and
`--device` (default cuda; no card raises, nothing falls back to the CPU):

    python -m reverb_tpu_torch.bin.infer_diarization a.wav b.flac \\
        --out-dir rttm/ [--model-dir DIR | --segmentation-ckpt seg.ckpt
        [--embedding-ckpt resnet34.pt]] [--device cpu]

`--model-dir` reads the JAX package's segmentation.npz and embedding.npz
(native nets at the default configs); without them the native nets are
randomly initialized from generators seeded 0 and 1, for smoke runs.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path


def build_diarizer(args):
    """The Diarizer the flags ask for, on args.device."""
    import torch

    from reverb_tpu_torch.convert import load_npz
    from reverb_tpu_torch.diar.convert import state_dict_from_jax
    from reverb_tpu_torch.diar.models import (EmbeddingConfig,
                                              SegmentationConfig,
                                              build_embedding,
                                              build_segmentation)
    from reverb_tpu_torch.diar.pipeline import Diarizer
    from reverb_tpu_torch.utils.common import resolve_device

    dev = resolve_device(args.device)
    if args.segmentation_ckpt:
        # released pyannote/wespeaker-format checkpoints (diar/pyannet.py)
        return Diarizer.from_pyannote_checkpoints(
            args.segmentation_ckpt, args.embedding_ckpt, device=dev)
    if args.model_dir and (args.model_dir / 'segmentation.npz').exists():
        seg_sd = state_dict_from_jax(
            load_npz(args.model_dir / 'segmentation.npz')[0], 'segmentation')
        emb_sd = state_dict_from_jax(
            load_npz(args.model_dir / 'embedding.npz')[0], 'embedding')
        seg = build_segmentation(SegmentationConfig(), dev, seg_sd)
        emb = build_embedding(EmbeddingConfig(), dev, emb_sd)
    else:
        seg = build_segmentation(SegmentationConfig(), dev, generator=(
            torch.Generator(device=dev).manual_seed(0)))
        emb = build_embedding(EmbeddingConfig(), dev, generator=(
            torch.Generator(device=dev).manual_seed(1)))
    return Diarizer(seg, emb, device=dev)


def main(argv=None):
    p = argparse.ArgumentParser(description='Run diarization on audio files')
    p.add_argument('audios', nargs='+')
    p.add_argument('--out-dir', type=Path, required=True)
    p.add_argument('--model-dir', type=Path, default=None,
                   help='dir with segmentation.npz + embedding.npz '
                        '(random init if absent — for smoke runs)')
    p.add_argument('--pipeline-model', type=str, default='reverb-diar-v1',
                   help='accepted for CLI parity')
    p.add_argument('--segmentation-ckpt', type=str, default=None,
                   help='pyannote-format PyanNet checkpoint (.ckpt/.bin), '
                        'e.g. a released Revai/reverb-diarization model')
    p.add_argument('--embedding-ckpt', type=str, default=None,
                   help='wespeaker ResNet34 embedding checkpoint (.pt)')
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device (default cuda; 'cpu' to run on the "
                        "CPU)")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    import numpy as np

    from reverb_tpu_torch.diar.pipeline import write_rttm
    from reverb_tpu_torch.frontend.audio import load_audio, resample, to_mono

    diar = build_diarizer(args)
    for audio in args.audios:
        print('Processing', audio)
        x, sr = load_audio(audio)
        x = to_mono(x)
        if sr != 16000:
            x = resample(x, sr, 16000)
        segments = diar(np.asarray(x, np.float32), 16000)
        uri = os.path.splitext(os.path.basename(audio))[0]
        with open(args.out_dir / f'{uri}.rttm', 'w') as f:
            write_rttm(f, segments, uri)


if __name__ == '__main__':
    main()
