"""The alternative encoders of the port against the JAX package's, f32 on
the CPU: Branchformer, E-Branchformer, Squeezeformer (through its time
reduction and recovery) and the Efficient Conformer (a grouped-attention
layer, a stride layer, a layer at the reduced rate), each at width 128 so
that every LayerNorm of the width takes the K5/K6 functions, and the
E-Branchformer with abs_pos (plain MHA); the encoder's forward on the
valid frames and the hybrid loss's gradient."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.models import encoders_alt as jalt
from torch_families import (ALT, alt_conf, assert_grads_close, batch,
                            both_bundles, losses_and_grads)

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

_JAX_FORWARD = {'branchformer': jalt.branchformer_forward,
                'e_branchformer': jalt.branchformer_forward,
                'squeezeformer': jalt.squeezeformer_forward,
                'efficient_conformer': jalt.efficient_conformer_forward}


@pytest.mark.parametrize('enc', ALT)
def test_alt_encoder_forward_and_gradients_match_jax(enc):
    _forward_and_gradients_match(enc, alt_conf(enc, width=128))


def test_e_branchformer_abs_pos_matches_jax():
    """pos_enc_layer_type abs_pos: the scaled input plus the sinusoid
    table after the subsampling, and plain MHA over the key-padding mask
    in every layer (no K1), as JAX's `att.mha`."""
    conf = alt_conf('e_branchformer', width=128)
    conf['encoder_conf']['pos_enc_layer_type'] = 'abs_pos'
    _forward_and_gradients_match('e_branchformer', conf)


def _forward_and_gradients_match(enc, conf):
    jb, tb = both_bundles(conf)
    ecfg = jb.cfg[0]
    b = batch(T=70, U=4)
    want, wmask = _JAX_FORWARD[enc](jb.params['encoder'],
                                    jnp.asarray(b['feats']),
                                    jnp.asarray(b['feats_lengths']), ecfg)
    with torch.no_grad():
        got, mask = tb.model.encoder(torch.from_numpy(b['feats']),
                                     torch.from_numpy(b['feats_lengths']))
    wmask = np.asarray(wmask)
    np.testing.assert_array_equal(mask.numpy(), wmask)
    valid = wmask[:, 0, :]
    assert got.shape == want.shape and valid.sum() > 0
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=1e-4)
    jout, tout, jg, tg = losses_and_grads(jb, tb, b)
    for k in ('loss', 'loss_att', 'loss_ctc'):
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), rtol=1e-5,
                                   err_msg=k)
    assert_grads_close(jg, tg)
