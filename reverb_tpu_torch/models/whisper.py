"""The Whisper family: encoder, decoder, greedy decoding and the weight
converters.

Counterpart of reverb_tpu/models/whisper.py (`WhisperConfig`,
`whisper_encode`, `whisper_decode`, `whisper_greedy_decode`,
`convert_hf_whisper`, `convert_wenet_whisper`, `load_hf_whisper`).  The
architecture is OpenAI Whisper's: log-mel (B, T, n_mels) → conv1d (k3, s1)
+ GELU → conv1d (k3, s2) + GELU → sinusoidal positions (or the carried
`positional_embedding` of a converted checkpoint) → pre-LN transformer
blocks → `ln_post`; the decoder adds a learned positional embedding to the
token embedding and runs pre-LN blocks with causal self-attention and
cross-attention, then `ln` and the tied output projection (or an untied
`output_layer`, as a WeNet checkpoint may carry).  K projections have no
bias; the GELU is the exact (erf) one.  Attention is the plain MHA of
models/attention.py (JAX's `att.mha`: no rel-pos, so kernel K1 does not
run here); the LayerNorms are K5/K6 where the width is eligible (1280 for
large-v3).

The state-dict keys are the JAX tree's (`encoder.conv1.weight`,
`encoder.blocks.{i}.self_attn.linear_q.weight`, `decoder.ln.bias`, ...),
so `convert.state_dict_from_jax` carries the JAX parameters across as
they are.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reverb_tpu_torch.models.attention import MultiHeadedAttention
from reverb_tpu_torch.models.embedding import pe_table
from reverb_tpu_torch.models.encoder import count_seq_step
from reverb_tpu_torch.models.modules import (Conv1d, Embedding, LayerNorm,
                                             Linear)


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4


def _gelu(x):
    return F.gelu(x)          # exact erf, as jax.nn.gelu(approximate=False)


class MLP(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.w_1 = Linear(d, 4 * d)
        self.w_2 = Linear(4 * d, d)
        # (-1, rank, n) when the hidden units are split over a 'model'
        # group (parallel/sharding.py: w_1 by columns, w_2 by rows)
        self.tp_split = None

    def forward(self, x):
        return self.w_2(_gelu(self.w_1(x)))


class WhisperBlock(nn.Module):
    """x + MHA(norm1(x)) [+ cross-MHA(norm2(x), audio)] + MLP(norm_mlp(x))."""

    def __init__(self, d: int, heads: int, cross: bool):
        super().__init__()
        self.self_attn = MultiHeadedAttention(heads, d, key_bias=False)
        self.norm1 = LayerNorm(d)
        self.mlp = MLP(d)
        self.norm_mlp = LayerNorm(d)
        if cross:
            self.cross_attn = MultiHeadedAttention(heads, d, key_bias=False)
            self.norm2 = LayerNorm(d)

    def forward(self, x, mask=None, audio=None):
        xn = self.norm1(x)
        x = x + self.self_attn(xn, xn, xn, mask)
        if audio is not None:
            x = x + self.cross_attn(self.norm2(x), audio, audio, None)
        return x + self.mlp(self.norm_mlp(x))


class WhisperEncoder(nn.Module):
    """Under 'seq' (`seq_split`, parallel/sharding.py) it runs whole on
    every rank (the stride-2 conv front and the plain attention have no
    split form; `seq_steps` counts the forwards)."""

    def __init__(self, cfg: WhisperConfig, pos_rows: int = 0):
        super().__init__()
        self.cfg = cfg
        self.seq_split = None
        self.seq_steps = {'split': 0, 'whole': 0}
        d = cfg.n_audio_state
        self.conv1 = Conv1d(cfg.n_mels, d, 3)
        self.conv2 = Conv1d(d, d, 3)
        # a converted checkpoint carries the exact sinusoid buffer (of
        # pos_rows rows); else the table is computed
        self.positional_embedding = (
            nn.Parameter(torch.empty(pos_rows, d)) if pos_rows else None)
        self.blocks = nn.ModuleList(
            WhisperBlock(d, cfg.n_audio_head, False)
            for _ in range(cfg.n_audio_layer))
        self.ln_post = LayerNorm(d)

    def reset_parameters(self, g):
        if self.positional_embedding is not None:
            with torch.no_grad():
                self.positional_embedding.copy_(torch.from_numpy(pe_table(
                    *self.positional_embedding.shape[::-1])))

    def forward(self, mel):
        """mel (B, T, n_mels) → (B, T', D), T' = (T − 1) // 2 + 1."""
        count_seq_step(self, False)
        x = mel.transpose(1, 2)
        for conv, stride in ((self.conv1, 1), (self.conv2, 2)):
            x = _gelu(F.conv1d(x, conv.weight.to(x.dtype),
                               conv.bias.to(x.dtype), stride=stride,
                               padding=1))
        x = x.transpose(1, 2)
        T = x.shape[1]
        if self.positional_embedding is not None:
            pos = self.positional_embedding
        else:
            pos = torch.from_numpy(pe_table(
                self.cfg.n_audio_state, max(T, self.cfg.n_audio_ctx))).to(
                    x.device)
        x = x + pos[None, :T].to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.ln_post(x)


class WhisperDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, pos_rows: int = 0,
                 output_layer: bool = False, output_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        d = cfg.n_text_state
        self.token_embedding = Embedding(cfg.n_vocab, d)
        self.positional_embedding = nn.Parameter(
            torch.empty(pos_rows or cfg.n_text_ctx, d))
        self.blocks = nn.ModuleList(
            WhisperBlock(d, cfg.n_text_head, True)
            for _ in range(cfg.n_text_layer))
        self.ln = LayerNorm(d)
        self.output_layer = (Linear(d, cfg.n_vocab, bias=output_bias)
                             if output_layer else None)

    def reset_parameters(self, g):
        with torch.no_grad():
            self.positional_embedding.normal_(generator=g).mul_(0.01)

    def hidden(self, tokens, audio):
        """tokens (B, L) → the final-norm states (B, L, D)."""
        L = tokens.shape[1]
        x = self.token_embedding(tokens.to(torch.int64))
        x = x + self.positional_embedding[None, :L].to(x.dtype)
        causal = torch.ones((L, L), dtype=torch.bool,
                            device=x.device).tril()[None]
        for blk in self.blocks:
            x = blk(x, causal, audio)
        return self.ln(x)

    def head(self, x):
        if self.output_layer is not None:
            return self.output_layer(x)
        return x @ self.token_embedding.weight.t().to(x.dtype)

    def forward(self, tokens, audio):
        """tokens (B, L), audio (B, T', D) → logits (B, L, V)."""
        return self.head(self.hidden(tokens, audio))


class Whisper(nn.Module):
    """`encoder.*` and `decoder.*` under the JAX tree's names."""

    def __init__(self, cfg: WhisperConfig, audio_pos_rows: int = 0,
                 text_pos_rows: int = 0, output_layer: bool = False,
                 output_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = WhisperEncoder(cfg, audio_pos_rows)
        self.decoder = WhisperDecoder(cfg, text_pos_rows, output_layer,
                                      output_bias)


def whisper_layout(state_dict: Optional[Dict]) -> Dict:
    """What a state dict holds beyond a random model, as `Whisper`'s
    keyword arguments: the carried positional tables' rows, an untied
    output layer and its bias."""
    sd = state_dict or {}

    def rows(side):
        t = sd.get(f'{side}.positional_embedding')
        return 0 if t is None else int(t.shape[0])
    return {'audio_pos_rows': rows('encoder'),
            'text_pos_rows': rows('decoder'),
            'output_layer': 'decoder.output_layer.weight' in sd,
            'output_bias': 'decoder.output_layer.bias' in sd}


def whisper_encode(model: Whisper, mel):
    return model.encoder(mel)


def whisper_decode(model: Whisper, tokens, audio_features):
    return model.decoder(tokens, audio_features)


@torch.no_grad()
def whisper_greedy_decode(model: Whisper, mel, sot_sequence: Sequence[int],
                          eot: int, max_len: int = 224) -> np.ndarray:
    """Batched greedy decoding with the JAX package's static-buffer loop:
    a (B, min(len(sot) + max_len, n_text_ctx)) buffer filled with `eot`
    past the prompt; each step takes the argmax (ties to the lower id) of
    the logits at the last decoded position, `eot` for a row already
    finished, until every row has finished or the buffer is full.
    Returns the tokens after the prompt (B, total − len(sot)), `eot`
    padded.  The causal mask keeps later positions invisible, so each
    step decodes the filled prefix alone and projects its last position."""
    cfg = model.cfg
    feats = model.encoder(mel)
    B = mel.shape[0]
    L0 = len(sot_sequence)
    total = min(L0 + max_len, cfg.n_text_ctx)
    dev = mel.device
    tokens = torch.full((B, total), eot, dtype=torch.int64, device=dev)
    tokens[:, :L0] = torch.as_tensor(list(sot_sequence), device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    for cur in range(L0, total):
        h = model.decoder.hidden(tokens[:, :cur], feats)
        nxt = model.decoder.head(h[:, -1]).argmax(-1)
        nxt = torch.where(finished, torch.full_like(nxt, eot), nxt)
        tokens[:, cur] = nxt
        finished |= nxt == eot
        if bool(finished.all()):
            break
    return tokens[:, L0:].cpu().numpy().astype(np.int32)


# ------------------------------ converters ------------------------------

def _params(g: Dict[str, np.ndarray], pairs) -> Dict[str, np.ndarray]:
    return {dst: np.asarray(g[src]) for dst, src in pairs if src in g}


def convert_hf_whisper(hf_state: Dict[str, np.ndarray]
                       ) -> Dict[str, np.ndarray]:
    """A HuggingFace WhisperForConditionalGeneration state dict → the flat
    JAX-tree keys of this module (the port's state dict, as
    reverb_tpu/models/whisper.py:convert_hf_whisper nests them)."""
    g = {k.replace('model.', '', 1): np.asarray(v)
         for k, v in hf_state.items()}
    pairs = []

    def lin(dst, src, bias=True):
        pairs.append((f'{dst}.weight', f'{src}.weight'))
        if bias:
            pairs.append((f'{dst}.bias', f'{src}.bias'))

    def ln(dst, src):
        lin(dst, src)

    def attn(dst, src):
        lin(f'{dst}.linear_q', f'{src}.q_proj')
        lin(f'{dst}.linear_k', f'{src}.k_proj', bias=False)
        lin(f'{dst}.linear_v', f'{src}.v_proj')
        lin(f'{dst}.linear_out', f'{src}.out_proj')

    def block(dst, src, cross):
        attn(f'{dst}.self_attn', f'{src}.self_attn')
        ln(f'{dst}.norm1', f'{src}.self_attn_layer_norm')
        lin(f'{dst}.mlp.w_1', f'{src}.fc1')
        lin(f'{dst}.mlp.w_2', f'{src}.fc2')
        ln(f'{dst}.norm_mlp', f'{src}.final_layer_norm')
        if cross:
            attn(f'{dst}.cross_attn', f'{src}.encoder_attn')
            ln(f'{dst}.norm2', f'{src}.encoder_attn_layer_norm')

    n_enc = len({k.split('.')[2] for k in g
                 if k.startswith('encoder.layers.')})
    n_dec = len({k.split('.')[2] for k in g
                 if k.startswith('decoder.layers.')})
    lin('encoder.conv1', 'encoder.conv1')
    lin('encoder.conv2', 'encoder.conv2')
    pairs.append(('encoder.positional_embedding',
                  'encoder.embed_positions.weight'))
    for i in range(n_enc):
        block(f'encoder.blocks.{i}', f'encoder.layers.{i}', False)
    ln('encoder.ln_post', 'encoder.layer_norm')
    pairs.append(('decoder.token_embedding.weight',
                  'decoder.embed_tokens.weight'))
    pairs.append(('decoder.positional_embedding',
                  'decoder.embed_positions.weight'))
    for i in range(n_dec):
        block(f'decoder.blocks.{i}', f'decoder.layers.{i}', True)
    ln('decoder.ln', 'decoder.layer_norm')
    return _params(g, pairs)


def convert_wenet_whisper(state: Dict[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
    """A WeNet-format Whisper state dict (the reference's
    convert_whisper_to_wenet_config_and_ckpt.py output) → the flat
    JAX-tree keys (reverb_tpu/models/whisper.py:convert_wenet_whisper): an
    output layer equal to the token embedding and without bias is the
    tied head and is dropped."""
    g = {k: np.asarray(v) for k, v in state.items()}
    pairs = []

    def lin(dst, src, bias=True):
        pairs.append((f'{dst}.weight', f'{src}.weight'))
        if bias:
            pairs.append((f'{dst}.bias', f'{src}.bias'))

    def attn(dst, src):
        lin(f'{dst}.linear_q', f'{src}.linear_q')
        lin(f'{dst}.linear_k', f'{src}.linear_k', bias=False)
        lin(f'{dst}.linear_v', f'{src}.linear_v')
        lin(f'{dst}.linear_out', f'{src}.linear_out')

    n_enc = 1 + max(int(k.split('.')[2]) for k in g
                    if k.startswith('encoder.encoders.'))
    n_dec = 1 + max(int(k.split('.')[2]) for k in g
                    if k.startswith('decoder.decoders.'))
    lin('encoder.conv1', 'encoder.embed.conv.0')
    lin('encoder.conv2', 'encoder.embed.conv.2')
    for i in range(n_enc):
        dst, src = f'encoder.blocks.{i}', f'encoder.encoders.{i}'
        attn(f'{dst}.self_attn', f'{src}.self_attn')
        lin(f'{dst}.norm1', f'{src}.norm1')
        lin(f'{dst}.mlp.w_1', f'{src}.feed_forward.w_1')
        lin(f'{dst}.mlp.w_2', f'{src}.feed_forward.w_2')
        lin(f'{dst}.norm_mlp', f'{src}.norm2')
    lin('encoder.ln_post', 'encoder.after_norm')
    pairs.append(('decoder.token_embedding.weight', 'decoder.embed.0.weight'))
    for i in range(n_dec):
        dst, src = f'decoder.blocks.{i}', f'decoder.decoders.{i}'
        attn(f'{dst}.self_attn', f'{src}.self_attn')
        lin(f'{dst}.norm1', f'{src}.norm1')
        attn(f'{dst}.cross_attn', f'{src}.src_attn')
        lin(f'{dst}.norm2', f'{src}.norm2')
        lin(f'{dst}.mlp.w_1', f'{src}.feed_forward.w_1')
        lin(f'{dst}.mlp.w_2', f'{src}.feed_forward.w_2')
        lin(f'{dst}.norm_mlp', f'{src}.norm3')
    lin('decoder.ln', 'decoder.after_norm')
    out = _params(g, pairs)
    out['encoder.positional_embedding'] = g['encoder.embed.pos_enc.pe'][0]
    out['decoder.positional_embedding'] = g['decoder.embed.1.pe'][0]
    if 'decoder.output_layer.weight' in g:
        w = g['decoder.output_layer.weight']
        if not np.array_equal(w, out['decoder.token_embedding.weight']) or \
                'decoder.output_layer.bias' in g:
            out['decoder.output_layer.weight'] = w
            if 'decoder.output_layer.bias' in g:
                out['decoder.output_layer.bias'] = g[
                    'decoder.output_layer.bias']
    return out


def build_whisper(cfg: WhisperConfig, flat: Dict[str, np.ndarray], device
                  ) -> Whisper:
    """A `Whisper` on `device` from flat JAX-tree keys (a converter's
    output), in eval mode."""
    from reverb_tpu_torch.convert import state_dict_from_jax
    sd = state_dict_from_jax(flat)
    with torch.device('meta'):
        model = Whisper(cfg, **whisper_layout(sd))
    model = model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def load_hf_whisper(model_name: str = 'openai/whisper-tiny'):
    """A HuggingFace Whisper checkpoint → (flat JAX-tree keys,
    WhisperConfig).  Needs the `transformers` package, imported here."""
    try:
        from transformers import WhisperForConditionalGeneration
    except ImportError as e:
        raise ImportError(
            'load_hf_whisper needs the transformers package; convert a '
            'local state dict with convert_hf_whisper instead') from e
    hf = WhisperForConditionalGeneration.from_pretrained(model_name)
    state = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    c = hf.config
    cfg = WhisperConfig(
        n_mels=c.num_mel_bins, n_audio_state=c.d_model,
        n_audio_head=c.encoder_attention_heads,
        n_audio_layer=c.encoder_layers, n_vocab=c.vocab_size,
        n_text_ctx=c.max_target_positions, n_text_state=c.d_model,
        n_text_head=c.decoder_attention_heads, n_text_layer=c.decoder_layers)
    return convert_hf_whisper(state), cfg
