"""The port's flow in both directions, its data-dependent init, and
BatchNorm in training mode, against the JAX package.

* Each flow layer, and the whole prior, run forward then in reverse: the
  input comes back and the two logdets cancel, to 1e-5 (as
  tests/test_flow.py holds the JAX layers).
* ``log_probability`` and the init pass (with the same injected base noise)
  match the JAX prior: latents and statistics atol 1e-4, log-probs rtol
  1e-5 + atol 1e-3 (sums over a few hundred terms of order 10).
* ActNorm's init statistics use the biased std over all positions.
* BatchNorm with ``train=True`` matches flax's ``nn.BatchNorm``: the output,
  and the running statistics after the update, to 1e-6. ``nn.BatchNorm1d``'s
  own training update (unbiased running variance) misses that tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaenar_tts_tpu.models import flow as jflow
from vaenar_tts_tpu.models import layers as jlay
from vaenar_tts_tpu.models.prior import TransformerPrior as JaxPrior
from vaenar_tts_torch.models import flow as tflow
from vaenar_tts_torch.models import layers as tlay
from vaenar_tts_torch.models.prior import TransformerPrior

from test_torch_modules import B, T, carry, close, lengths, x_of

INV_TOL = 1e-5


def _roundtrip(layer, x, *args, **kwargs):
    with torch.no_grad():
        y, ld_f = layer(x, *args, **kwargs)
        x2, ld_r = layer(y, *args, reverse=True, **kwargs)
    torch.testing.assert_close(x2, x, atol=INV_TOL, rtol=0)
    torch.testing.assert_close(ld_f + ld_r, torch.zeros_like(ld_f), atol=INV_TOL, rtol=0)
    assert not torch.allclose(y, x, atol=1e-2)  # the layer did something


@pytest.mark.parametrize("layer", ["actnorm", "invertible_linear", "coupling_upper",
                                   "coupling_lower"])
def test_reverse_inverts_forward(layer):
    z, cond = x_of(B, 10, 8), x_of(B, 6, 12, seed=3)
    zl, cl = lengths(10), lengths(6, seed=4)
    if layer.startswith("coupling"):
        order = layer.split("_")[1]
        jm = jflow.TransformerCoupling(channels=8, nblk=1, attention_dim=16,
                                       attention_heads=2, temperature=1.0,
                                       ffn_hidden=24, order=order)
        tm = tflow.TransformerCoupling(8, 12, 1, 16, 2, 1.0, 24, order=order)
        carry(jm, (z, cond, zl, cl), tm)
        _roundtrip(tm, T(z), T(cond), T(zl), T(cl))
        return
    jm, tm = {"actnorm": (jflow.ActNorm(8), tflow.ActNorm(8)),
              "invertible_linear": (jflow.InvertibleLinear(8),
                                    tflow.InvertibleLinear(8))}[layer]
    v = carry(jm, (z, zl), tm)
    _roundtrip(tm, T(z), T(zl))
    # the reverse direction against the JAX layer's
    out, logdet = jm.apply(v, z, zl, reverse=True)
    t_out, t_logdet = tm(T(z), T(zl), reverse=True)
    close(t_out, out)
    close(t_logdet, logdet)


@pytest.fixture(scope="module")
def prior():
    kw = dict(n_blk=2, channels=8, n_transformer_blk=1, attention_dim=16,
              attention_heads=2, temperature=1.0, ffn_hidden=24)
    jm = JaxPrior(**kw)
    tm = TransformerPrior(2, 8, 12, 1, 16, 2, 1.0, 24)
    cond, zl, cl = x_of(B, 6, 12, seed=3), lengths(20), lengths(6, seed=4)
    v = carry(jm, (zl, cond, cl), tm, max_length=20, method=JaxPrior.sample)
    return jm, tm, v, cond, zl, cl


def test_prior_log_probability_inverts_sample_and_matches_jax(prior):
    jm, tm, v, cond, zl, cl = prior
    eps = x_of(B, 20, 8, seed=6)
    with torch.no_grad():
        z, logp = tm.sample(T(zl), T(cond), T(cl), max_length=20, epsilon=T(eps))
        t_logp = tm.log_probability(z, T(cond), T(zl), T(cl))
    torch.testing.assert_close(t_logp, logp, rtol=INV_TOL, atol=1e-3)
    j_logp = jm.apply(v, z.numpy(), cond, z_lengths=zl, condition_lengths=cl,
                      method=JaxPrior.log_probability)
    np.testing.assert_allclose(t_logp.numpy(), np.asarray(j_logp), rtol=1e-5, atol=1e-3)


def test_init_pass_matches_jax_with_injected_noise(prior):
    jm, tm, v, cond, zl, cl = prior
    eps = x_of(B, 20, 8, seed=7)
    (z, _), aux = jm.apply(
        v, jnp.asarray(eps), jnp.zeros((B,)), cond, zl, cl,
        method=lambda m, *a: m._forward_stack(*a, data_init=True),
        mutable=["flow_init"])
    before = {k: p.clone() for k, p in tm.state_dict().items()}
    with torch.no_grad():
        t_z, flow_init = tm.init_pass(T(cond), T(zl), T(cl), max_length=20,
                                      epsilon=T(eps))
    close(t_z, z)
    for name, (log_scale, bias) in flow_init.items():
        sown = aux["flow_init"][name]
        close(log_scale, sown["log_scale"])
        close(bias, sown["bias"])
    # the pass applies its statistics without writing them into the params
    for k, p in tm.state_dict().items():
        assert torch.equal(p, before[k]), k


def test_actnorm_init_uses_the_biased_std_over_all_positions():
    x = x_of(3, 7, 5, seed=8) * 2.0 + 1.0
    log_scale, bias = tflow.actnorm_init_stats(T(x))
    flat = x.reshape(-1, 5)
    std = flat.std(axis=0)  # numpy's default: ddof 0
    np.testing.assert_allclose(log_scale.numpy(), np.log(1.0 / (std + 1e-8)), rtol=1e-5)
    np.testing.assert_allclose(bias.numpy(), -flat.mean(axis=0) / (std + 1e-8), rtol=1e-5)
    jm = jflow.ActNorm(5)
    v = jm.init(jax.random.key(0), x)
    _, aux = jm.apply(v, x, data_init=True, mutable=["flow_init"])
    close(log_scale, aux["flow_init"]["log_scale"], atol=1e-6)


@pytest.mark.parametrize("bn_before_act", [False, True])
def test_batchnorm_train_mode_matches_flax(bn_before_act):
    """Fault repaired in the port: BatchNorm's running variance moves with
    the biased batch variance, as in flax."""
    x = x_of(B, 13, 6)
    jm = jlay.Conv1D(8, 3, "relu", 0.0, bn_before_act)
    tm = tlay.Conv1D(6, 8, 3, "relu", bn_before_act)
    v = carry(jm, (x,), tm)
    out, upd = jm.apply(v, x, train=True, mutable=["batch_stats"])
    t_out = tm(T(x), train=True)
    close(t_out, out, atol=1e-5)
    stats = upd["batch_stats"]["batch_norm"]
    bn = tm.batch_norm
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-6, atol=1e-6)

    # torch's own training update lands outside that tolerance
    plain = torch.nn.BatchNorm1d(8, eps=1e-3, momentum=0.01).train()
    with torch.no_grad():
        plain.running_var.copy_(torch.from_numpy(np.asarray(
            v["batch_stats"]["batch_norm"]["var"])))
        y = tm.conv1d(torch.nn.functional.pad(T(x).transpose(1, 2), tm.pad))
        plain(y if bn_before_act else torch.relu(y))
    assert not np.allclose(plain.running_var.numpy(), np.asarray(stats["var"]),
                           rtol=1e-6, atol=1e-6)

