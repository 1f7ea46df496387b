"""Each module of the port against its JAX counterpart, at small widths.

Every flax module is initialised, its parameters and batch statistics are
replaced with random values from a numpy seed (so zero-initialised heads,
unit BatchNorm statistics and identity-like flows do not hide a mapping
fault), carried into the torch module by ``load_jax_weights``, and both run
on the same numpy inputs on the CPU. Tolerance: atol 1e-4 in fp32, a few
hundred ulps at these magnitudes, for sums and LayerNorm variances taken in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaenar_tts_tpu.models import attention as jatt
from vaenar_tts_tpu.models import decoder as jdec
from vaenar_tts_tpu.models import encoder as jenc
from vaenar_tts_tpu.models import flow as jflow
from vaenar_tts_tpu.models import layers as jlay
from vaenar_tts_tpu.models import length_predictor as jlen
from vaenar_tts_tpu.models import posterior as jpost
from vaenar_tts_torch.interop.weights import load_jax_weights
from vaenar_tts_torch.models import attention as tatt
from vaenar_tts_torch.models import decoder as tdec
from vaenar_tts_torch.models import encoder as tenc
from vaenar_tts_torch.models import flow as tflow
from vaenar_tts_torch.models import layers as tlay
from vaenar_tts_torch.models import length_predictor as tlen
from vaenar_tts_torch.models import posterior as tpost

ATOL = 1e-4
B = 2


def randomize(tree, rng):
    """Same structure, random leaves: BatchNorm variances in [0.5, 1.5],
    InvertibleLinear weights near the identity, the rest N(0, 0.3²)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out[key] = randomize(value, rng)
            continue
        shape = np.shape(value)
        if key == "var":
            leaf = rng.uniform(0.5, 1.5, shape)
        elif key == "weight":
            leaf = np.eye(shape[0]) + 0.1 * rng.standard_normal(shape)
        else:
            leaf = 0.3 * rng.standard_normal(shape)
        out[key] = leaf.astype(np.float32)
    return out


def carry(jax_module, init_args, torch_module, seed=0, **init_kwargs):
    """Init the flax module, randomise its variables, load them into the
    torch module; return the variables for ``jax_module.apply``."""
    variables = jax_module.init(jax.random.key(seed), *init_args, **init_kwargs)
    rng = np.random.default_rng(seed + 100)
    params = randomize(variables["params"], rng)
    stats = randomize(variables.get("batch_stats", {}), rng)
    load_jax_weights(torch_module, params, stats)
    torch_module.eval()
    return {"params": params, "batch_stats": stats}


def x_of(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def lengths(maxlen, seed=2):
    lens = np.random.default_rng(seed).integers(maxlen // 3, maxlen + 1, (B,))
    lens[0] = maxlen  # one full row, one ragged
    return lens.astype(np.int32)


def close(torch_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out),
                               atol=atol, rtol=1e-4)


def T(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("step", [1.0, 4.5])
def test_positional_encoding(step):
    close(tlay.positional_encoding(37, 24, step=step),
          jlay.positional_encoding(37, 24, step=step))


def test_sequence_mask():
    lens = lengths(11)
    assert np.array_equal(tlay.sequence_mask(T(lens), 11).numpy(),
                          np.asarray(jlay.sequence_mask(jnp.asarray(lens), 11)))


@pytest.mark.parametrize("kernel,activation,bn_before_act",
                         [(5, "relu", False), (3, "tanh", True), (4, "identity", False)])
def test_conv1d(kernel, activation, bn_before_act):
    x = x_of(B, 13, 6)
    jm = jlay.Conv1D(8, kernel, activation, 0.0, bn_before_act)
    tm = tlay.Conv1D(6, 8, kernel, activation, bn_before_act)
    v = carry(jm, (x,), tm)
    close(tm(T(x)), jm.apply(v, x))


def test_conv_prenet_prenet_ffn_postnet():
    x = x_of(B, 13, 8)
    cases = [
        (jlay.ConvPreNet(nconv=2, hidden=12, conv_kernel=3, drop_rate=0.0,
                         bn_before_act=False),
         tlay.ConvPreNet(8, 2, 12, 3, "relu", bn_before_act=False)),
        (jlay.PreNet(units=12, drop_rate=0.0), tlay.PreNet(8, 12)),
        (jlay.FFN(20, 8), tlay.FFN(8, 20)),
        (jlay.PostNet(n_conv=3, conv_filters=8, conv_kernel=5, drop_rate=0.0),
         tlay.PostNet(8, 3, 8, 5)),
    ]
    for i, (jm, tm) in enumerate(cases):
        v = carry(jm, (x,), tm, seed=i)
        close(tm(T(x)), jm.apply(v, x))


@pytest.mark.parametrize("causal,tk", [(True, 12), (False, 7)])
def test_multi_head_attention(causal, tk):
    tq = 12
    x, mem = x_of(B, tq, 16), x_of(B, tk, 10, seed=3)
    ql, ml = lengths(tq), lengths(tk, seed=4)
    mem_in = x if causal else mem
    jm = jatt.MultiHeadAttention(16, 2, temperature=1.3)
    tm = tatt.MultiHeadAttention(16, mem_in.shape[-1], 16, 2, temperature=1.3)
    v = carry(jm, (x, mem_in, ql, ml), tm, causal=causal)
    out, _ = jm.apply(v, x, mem_in, ql, ml, causal=causal)
    close(tm(T(x), T(mem_in), T(ql), T(ml), causal=causal), out)


def test_self_and_cross_attention_blocks():
    x, mem = x_of(B, 12, 16), x_of(B, 7, 24, seed=3)
    ql, ml = lengths(12), lengths(7, seed=4)
    jm = jatt.SelfAttentionBlock(16, 8, 2, ffn_hidden=32)
    tm = tatt.SelfAttentionBlock(16, 8, 2, ffn_hidden=32)
    v = carry(jm, (x, x, ql, ql), tm)
    close(tm(T(x), T(x), T(ql), T(ql)), jm.apply(v, x, x, ql, ql)[0])

    jm = jatt.CrossAttentionBlock(16, 16, 2, ffn_hidden=32)
    tm = tatt.CrossAttentionBlock(16, 24, 16, 2, ffn_hidden=32)
    v = carry(jm, (x, mem, ql, ml), tm, seed=1)
    close(tm(T(x), T(mem), T(ql), T(ml)), jm.apply(v, x, mem, ql, ml)[0])


def test_encoder():
    ids = np.random.default_rng(5).integers(0, 43, (B, 16)).astype(np.int32)
    tl = lengths(16)
    kw = dict(vocab_size=43, embd_dim=12, pre_nconv=2, pre_hidden=16,
              pre_conv_kernel=3, pre_activation="relu", bn_before_act=False,
              nblk=2, attention_dim=8, attention_heads=2,
              attention_temperature=1.0, ffn_hidden=24)
    jm = jenc.TransformerEncoder(prenet_drop_rate=0.0, pos_drop_rate=0.0, **kw)
    tm = tenc.TransformerEncoder(**kw)
    v = carry(jm, (ids, tl), tm, pos_step=4.5)
    close(tm(T(ids).long(), T(tl), pos_step=4.5), jm.apply(v, ids, tl, pos_step=4.5))


def test_length_predictor_heads():
    x = x_of(B, 10, 16)
    tl = lengths(10)
    jm = jlen.DenseLengthPredictor(quantile=0.9)
    tm = tlen.DenseLengthPredictor(16, quantile=0.9)
    v = carry(jm, (x, tl), tm)
    close(tm(T(x), T(tl)), jm.apply(v, x, tl), atol=1e-3)
    close(tm.quantile_lengths(T(x), T(tl)),
          jm.apply(v, x, tl, method=jlen.DenseLengthPredictor.quantile_lengths),
          atol=1e-3)
    assert tlen.DenseLengthPredictor(16).q_projection is None


def test_actnorm_and_invertible_linear():
    x = x_of(B, 9, 8)
    zl = lengths(9)
    for jm, tm in [(jflow.ActNorm(8), tflow.ActNorm(8)),
                   (jflow.InvertibleLinear(8), tflow.InvertibleLinear(8))]:
        v = carry(jm, (x, zl), tm)
        out, logdet = jm.apply(v, x, zl)
        t_out, t_logdet = tm(T(x), T(zl))
        close(t_out, out)
        close(t_logdet, logdet)


@pytest.mark.parametrize("order", ["upper", "lower"])
def test_coupling(order):
    z, cond = x_of(B, 10, 8), x_of(B, 6, 12, seed=3)
    zl, cl = lengths(10), lengths(6, seed=4)
    jm = jflow.TransformerCoupling(channels=8, nblk=2, attention_dim=16,
                                   attention_heads=2, temperature=1.0,
                                   ffn_hidden=24, order=order)
    tm = tflow.TransformerCoupling(8, 12, 2, 16, 2, 1.0, 24, order=order)
    v = carry(jm, (z, cond, zl, cl), tm)
    out, logdet = jm.apply(v, z, cond, zl, cl)
    t_out, t_logdet = tm(T(z), T(cond), T(zl), T(cl))
    close(t_out, out)
    close(t_logdet, logdet)


def test_decoder():
    z, text = x_of(B, 10, 8), x_of(B, 6, 12, seed=3)
    zl, tl = lengths(10), lengths(6, seed=4)
    jm = jdec.TransformerDecoder(
        nblk=2, attention_dim=16, attention_heads=2, temperature=1.0,
        ffn_hidden=24, post_n_conv=2, post_conv_filters=8, post_conv_kernel=3,
        post_drop_rate=0.0, out_dim=6, max_reduction_factor=5)
    tm = tdec.TransformerDecoder(8, 12, 2, 16, 2, 1.0, 24, 2, 8, 3, 6, 5)
    v = carry(jm, (z, text, zl, tl), tm, reduction_factor=2)
    initial, outputs, _ = jm.apply(v, z, text, zl, tl, reduction_factor=2)
    t_initial, t_outputs = tm(T(z), T(text), T(zl), T(tl), reduction_factor=2)
    assert t_outputs.shape == (B, 20, 6)
    close(t_initial, initial)
    close(t_outputs, outputs)


def test_posterior():
    mels, text = x_of(B, 10, 6), x_of(B, 7, 12, seed=3)
    ml, tl = lengths(10), lengths(7, seed=4)
    jm = jpost.TransformerPosterior(
        pre_hidden=16, pre_drop_rate=0.0, pre_activation="relu",
        pos_drop_rate=0.0, nblk=1, attention_dim=16, attention_heads=2,
        temperature=1.0, ffn_hidden=24, latent_dim=4)
    tm = tpost.TransformerPosterior(6, 12, 16, "relu", 1, 16, 2, 1.0, 24, 4)
    v = carry(jm, (mels, text, tl, ml), tm)
    mu, logvar = jm.apply(v, mels, text, tl, ml)
    t_mu, t_logvar = tm(T(mels), T(text), T(tl), T(ml))
    close(t_mu, mu)
    close(t_logvar, logvar)
