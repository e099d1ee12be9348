"""Model presets (the reverb_tpu/models/presets.py configurations).

`reverb_large` mirrors the reverb_asr_v1 architecture family (conformer
encoder with LSL verbatimicity layers + bidirectional transformer decoder,
SURVEY.md §2.3); exact released dims are read from the model's config.yaml at
load time — this preset is the benchmarking/training default.
"""

from __future__ import annotations


def reverb_config(output_size=1024, attention_heads=16, linear_units=4096,
                  num_blocks=18, dec_blocks=6, r_blocks=3, vocab_size=10000,
                  num_mel_bins=80, cnn_module_kernel=15, dropout=0.1):
    return {
        'input_dim': num_mel_bins,
        'output_dim': vocab_size,
        'encoder': 'conformer',
        'encoder_conf': {
            'output_size': output_size,
            'attention_heads': attention_heads,
            'linear_units': linear_units,
            'num_blocks': num_blocks,
            'dropout_rate': dropout,
            'positional_dropout_rate': dropout,
            'attention_dropout_rate': dropout,
            'input_layer': 'conv2d',
            'pos_enc_layer_type': 'rel_pos',
            'selfattention_layer_type': 'rel_selfattn',
            'activation_type': 'swish',
            'macaron_style': True,
            'use_cnn_module': True,
            'cnn_module_kernel': cnn_module_kernel,
            'cnn_module_norm': 'batch_norm',
        },
        'decoder': 'bitransformer',
        'decoder_conf': {
            'attention_heads': attention_heads,
            'linear_units': linear_units,
            'num_blocks': dec_blocks,
            'r_num_blocks': r_blocks,
            'dropout_rate': dropout,
            'positional_dropout_rate': dropout,
            'self_attention_dropout_rate': dropout,
            'src_attention_dropout_rate': dropout,
        },
        'model': 'asr_model',
        'model_conf': {'ctc_weight': 0.3, 'reverse_weight': 0.3,
                       'lsm_weight': 0.1, 'length_normalized_loss': False},
        'ctc_conf': {'ctc_blank_id': 0},
        'dataset_conf': {
            'fbank_conf': {'num_mel_bins': num_mel_bins, 'frame_length': 25,
                           'frame_shift': 10, 'dither': 0.1},
            'pass_cat_emb': True,
            'cat_emb_conf': {'field': 'style', 'emb_len': 2,
                             'one_hot_ids': {'verbatim': 0,
                                             'nonverbatim': 1}},
        },
        'optim': 'adam',
        'optim_conf': {'lr': 1e-3},
        'scheduler': 'warmuplr',
        'scheduler_conf': {'warmup_steps': 25000},
        'grad_clip': 50.0, 'accum_grad': 1,
    }


def reverb_large():
    """~620M-param flagship (reverb_asr_v1-class)."""
    return reverb_config()


def reverb_small():
    """Fast-compile variant with the full architecture (LSL, bidecoder)."""
    return reverb_config(output_size=256, attention_heads=4,
                         linear_units=1024, num_blocks=6, dec_blocks=3,
                         r_blocks=1, vocab_size=2000)


def reverb_tiny():
    """CI-size variant for CPU-mesh tests."""
    return reverb_config(output_size=32, attention_heads=2, linear_units=64,
                         num_blocks=3, dec_blocks=2, r_blocks=1,
                         vocab_size=64)
