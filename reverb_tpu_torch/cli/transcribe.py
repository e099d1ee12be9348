"""Upstream-style `wenet` transcribe CLI on PyTorch:
`python -m reverb_tpu_torch.cli.transcribe`.

Counterpart of reverb_tpu/cli/transcribe.py (reference
asr/wenet/cli/transcribe.py) for a local model: `-m/--model_dir` names the
model directory, `--align --label TEXT` runs CTC forced alignment
(decode/ctc_utils.py) instead of decoding, `-t/--show_tokens_info` prints a
CTM, `--context_path/--context_score` bias the beam with a context graph
(decode/context_graph.py).  `--device` (default cuda; raises without a
card unless `--device cpu`).  `--paraformer` runs the NAR Ali-Paraformer
runtime (cli/paraformer_model.py) on the model directory and prints its
result dict as JSON.  Without `--model_dir` it raises: the hub route
downloads.
"""

from __future__ import annotations

import argparse
import json


def get_args(argv=None):
    p = argparse.ArgumentParser(description='transcribe (local models)')
    p.add_argument('audio_file', help='audio file to transcribe')
    p.add_argument('-l', '--language', default='english',
                   help='hub language tag (the hub route is not ported)')
    p.add_argument('-m', '--model_dir', default=None,
                   help='local model dir (config.yaml + checkpoint)')
    p.add_argument('-t', '--show_tokens_info', action='store_true')
    p.add_argument('--align', action='store_true',
                   help='force-align audio against --label')
    p.add_argument('--label', type=str, default=None)
    p.add_argument('--beam', type=int, default=5)
    p.add_argument('--context_path', type=str, default=None)
    p.add_argument('--context_score', type=float, default=6.0)
    p.add_argument('--mode', default='ctc_prefix_beam_search')
    p.add_argument('--paraformer', action='store_true',
                   help='use the NAR Ali-Paraformer runtime '
                        '(cli/paraformer_model.py)')
    p.add_argument('--device', default='cuda',
                   help='torch device (default cuda; raises without a card)')
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    if args.paraformer:
        from reverb_tpu_torch.cli.paraformer_model import \
            load_model as load_paraformer
        model = load_paraformer(args.model_dir, device=args.device)
        result = model.transcribe(args.audio_file,
                                  tokens_info=args.show_tokens_info)
        print(json.dumps(result, ensure_ascii=False))
        return result
    if not args.model_dir:
        raise ValueError('-m/--model_dir is required: the hub route '
                         '(--language) downloads, which is not supported')
    if args.align and not args.label:
        raise ValueError('--align needs --label')
    from reverb_tpu_torch.cli.reverb import load_model
    model = load_model(args.model_dir, device=args.device)

    if args.align:
        result = align(model, args.audio_file, args.label)
        print(json.dumps(result, ensure_ascii=False))
        return result

    kwargs = {}
    if args.context_path:
        from reverb_tpu_torch.decode.context_graph import ContextGraph
        kwargs['context_graph'] = ContextGraph(
            context_list_path=args.context_path, tokenizer=model.tokenizer,
            context_score=args.context_score)
    res = model.transcribe_modes(args.audio_file, [args.mode],
                                 format='ctm' if args.show_tokens_info
                                 else 'txt',
                                 beam_size=args.beam, **kwargs)[0]
    print(res)
    return res


def align(model, audio_file: str, label: str):
    """CTC forced alignment of `label` to the audio: token-level times (the
    JAX package's transcribe.align)."""
    import torch

    from reverb_tpu_torch.decode.api import encode_and_ctc
    from reverb_tpu_torch.decode.ctc_utils import (force_align,
                                                   gen_ctc_peak_time,
                                                   gen_timestamps_from_peak)
    feats = model.compute_feats(audio_file)                  # (T, M)
    dev = model.device
    cat = torch.tensor([1.0, 0.0], device=dev)
    with torch.inference_mode():
        _, enc_lens, ctc_probs = encode_and_ctc(
            model.model, feats[None],
            torch.tensor([feats.shape[0]], device=dev), cat)
        tokens, ids = model.tokenizer.tokenize(label)
        T = int(enc_lens[0])
        ali = force_align(ctc_probs[0][:T], ids, model.model.cfg.blank_id)
    peaks = gen_ctc_peak_time(ali)
    frame_s = 0.04  # 4x subsampled 10 ms frames
    times = gen_timestamps_from_peak(peaks, max_duration=T * frame_s,
                                     frame_rate=frame_s)
    return {'text': label,
            'tokens': [{'token': t, 'start': round(s, 3),
                        'end': round(e, 3)}
                       for t, (s, e) in zip(tokens, times)]}


if __name__ == '__main__':
    main()
