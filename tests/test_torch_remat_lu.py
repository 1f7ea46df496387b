"""Activation checkpointing (``train.remat``) and the batched LU of the
flow (``prior.batched_lu``) in the port, on the CPU at tiny size:

* a train step with remat "on" and "dots" gives the loss and every gradient
  element of remat "off" from the same weights, batch and generator state,
  with dropout ON (rates 0.5), so that a recompute drawing other dropout
  masks than the forward would show: the same fp32 ops run again on the same
  inputs, so the bound is 1e-6 relative to the largest element of a leaf;
* a bad remat value raises, in the config and in ``maybe_remat``, as the
  JAX package's ``maybe_remat`` does (tests/test_training.py);
* ``precompute_invertible_stack`` against the JAX package's on the same
  [3, 8, 8] stack (matrices within 1e-5 of their largest element, log|det|
  within 1e-5), and the prior's
  ``log_probability`` and ``sample`` with ``batched_lu`` against the
  per-layer path within 1e-5 relative, gradients too;
* the fields that the port used to drop (``remat``, ``batched_lu``,
  ``test_interval``, ``test_batch_size``, ``device_data_cache_mb``,
  ``device_cache_epoch_scan``) load from an ``hparams.json`` that the JAX
  package wrote.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vaenar_tts_tpu.configs import get_config as jax_get_config
from vaenar_tts_tpu.configs.serialize import save_hparams as jax_save_hparams
from vaenar_tts_tpu.models.flow import precompute_invertible_stack as jax_precompute
from vaenar_tts_torch.configs.hparams import HParams, TrainConfig
from vaenar_tts_torch.configs.overrides import apply_overrides
from vaenar_tts_torch.configs.serialize import load_hparams
from vaenar_tts_torch.interop.weights import load_jax_weights, torch_to_jax
from vaenar_tts_torch.models.attention import maybe_remat
from vaenar_tts_torch.models.flow import precompute_invertible_stack
from vaenar_tts_torch.models.vaenar import VAENAR
from vaenar_tts_torch.training import steps

from test_torch_model import TINY_OVERRIDES, randomize_model
from test_torch_modules import randomize

DROPOUT_ON = ["encoder.pre_drop_rate=0.5", "encoder.pos_drop_rate=0.5",
              "decoder.post_drop_rate=0.5", "posterior.pre_drop_rate=0.5",
              "posterior.pos_drop_rate=0.5"]
REMAT_RTOL = 1e-6
LU_RTOL = 1e-5
B, TEXT, MEL, R = 2, 32, 120, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny(*extra):
    base = [o for o in TINY_OVERRIDES if not o.startswith("train.")]
    return apply_overrides(HParams(), base + ["train.compute_dtype=float32", "prior.n_blk=2",
                                              *extra])


def random_state(hp, seed=5):
    params, stats = torch_to_jax(VAENAR(hp))
    rng = np.random.default_rng(seed)
    model = VAENAR(hp)
    load_jax_weights(model, randomize_model(params, rng), randomize(stats, rng))
    return model.state_dict()


def batch(seed=0):
    rng = np.random.default_rng(seed)
    texts = rng.integers(3, 43, (B, TEXT))
    texts[1, 19:] = 0
    mels = rng.uniform(0, 1, (B, MEL, 80)).astype(np.float32)
    mels[1, 101:] = 0
    return (torch.from_numpy(texts).long(), torch.from_numpy(mels),
            torch.tensor([TEXT, 19], dtype=torch.int32),
            torch.tensor([MEL, 101], dtype=torch.int32))


def step_with(hp, state):
    model = VAENAR(hp)
    model.load_state_dict(state)
    gen = torch.Generator().manual_seed(77)
    metrics = steps.train_step(model, steps.make_optimizer(hp, model), hp, *batch(), 0.5, R, gen)
    return steps.metric_floats(metrics), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("mode", ["on", "dots"])
def test_remat_matches_off_with_dropout(mode):
    hp_off = tiny(*DROPOUT_ON)
    state = random_state(hp_off)
    m_off, g_off = step_with(hp_off, state)
    m_on, g_on = step_with(apply_overrides(hp_off, [f"train.remat={mode}"]), state)
    for k, v in m_off.items():
        assert abs(m_on[k] - v) <= REMAT_RTOL * abs(v), (k, m_on[k], v)
    assert sorted(g_on) == sorted(g_off)
    for name, g in g_off.items():
        err = (g_on[name] - g).abs().max().item()
        assert err <= REMAT_RTOL * g.abs().max().item(), (name, err)
    assert any(g.abs().max() > 0 for g in g_off.values())


def test_dropout_is_drawn_in_the_step():
    """The generator state matters: another seed gives other losses, so the
    remat test above compares draws, not a deterministic step."""
    hp = tiny(*DROPOUT_ON)
    state = random_state(hp)
    model = VAENAR(hp)
    model.load_state_dict(state)
    out = []
    for seed in (77, 78):
        model.load_state_dict(state)
        gen = torch.Generator().manual_seed(seed)
        out.append(steps.metric_floats(steps.train_step(
            model, steps.make_optimizer(hp, model), hp, *batch(), 0.5, R, gen))["mel_l2"])
    assert out[0] != out[1]


def test_bad_remat_value_raises():
    with pytest.raises(ValueError, match="remat"):
        TrainConfig(remat="bogus")
    with pytest.raises(ValueError, match="remat"):
        maybe_remat(torch.nn.Identity(), "bogus")
    with pytest.raises(ValueError, match="remat"):
        apply_overrides(HParams(), ["train.remat=sometimes"])


@pytest.mark.parametrize("reverse", [False, True])
def test_precompute_matches_jax(reverse):
    rng = np.random.default_rng(3)
    w = (np.eye(8) + 0.3 * rng.standard_normal((3, 8, 8))).astype(np.float32)
    mats, logdets = precompute_invertible_stack(torch.from_numpy(w), reverse)
    jmats, jlogdets = jax_precompute(w, reverse)
    jmats = np.asarray(jmats)
    np.testing.assert_allclose(mats.numpy(), jmats, rtol=0,
                               atol=LU_RTOL * np.abs(jmats).max())
    np.testing.assert_allclose(logdets.numpy(), np.asarray(jlogdets), rtol=0, atol=LU_RTOL)
    _, want = np.linalg.slogdet(w.astype(np.float64))
    np.testing.assert_allclose(logdets.numpy(), want, rtol=0, atol=LU_RTOL)


def test_batched_lu_matches_per_layer_prior():
    hp = tiny()
    state = random_state(hp)
    rng = np.random.default_rng(9)
    cond = torch.from_numpy(rng.standard_normal((B, TEXT, 32)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((B, MEL // R, 8)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((B, MEL // R, 8)).astype(np.float32))
    z_lens = torch.tensor([MEL // R, 50], dtype=torch.int32)
    t_lens = torch.tensor([TEXT, 19], dtype=torch.int32)
    out = {}
    for on in (False, True):
        model = VAENAR(apply_overrides(hp, [f"prior.batched_lu={on}"]))
        model.load_state_dict(state)
        assert model.prior.batched_lu is on
        logp = model.prior.log_probability(z, cond, z_lens, t_lens)
        logp.sum().backward()
        sample, sample_logp = model.prior.sample(z_lens, cond, t_lens, max_length=MEL // R,
                                                 epsilon=eps)
        grads = {n: p.grad.clone() for n, p in model.prior.named_parameters()
                 if "invertible_linear" in n}
        out[on] = (logp.detach(), sample.detach(), sample_logp.detach(), grads)
    for a, b in zip(out[False][:3], out[True][:3]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=LU_RTOL,
                                   atol=LU_RTOL * a.abs().max().item())
    for name, g in out[False][3].items():
        np.testing.assert_allclose(out[True][3][name].numpy(), g.numpy(), rtol=0,
                                   atol=LU_RTOL * g.abs().max().item())


def test_new_fields_load_from_a_jax_hparams_json(tmp_path):
    jdef = jax_get_config("ljspeech")
    jhp = dataclasses.replace(
        jdef, train=dataclasses.replace(
            jdef.train, remat="dots", test_interval=7, test_batch_size=3,
            device_data_cache_mb=64, device_cache_epoch_scan=True),
        prior=dataclasses.replace(jdef.prior, batched_lu=True))
    jax_save_hparams(jhp, str(tmp_path))
    hp = load_hparams(str(tmp_path))
    assert (hp.train.remat, hp.prior.batched_lu, hp.train.test_interval,
            hp.train.test_batch_size, hp.train.device_data_cache_mb,
            hp.train.device_cache_epoch_scan) == ("dots", True, 7, 3, 64, True)
    # the JAX defaults are the port's
    pdef = HParams()
    for section, name in (("train", "remat"), ("prior", "batched_lu"),
                          ("train", "test_interval"), ("train", "test_batch_size"),
                          ("train", "device_data_cache_mb"),
                          ("train", "device_cache_epoch_scan")):
        assert getattr(getattr(pdef, section), name) == getattr(getattr(jdef, section), name)
    assert dataclasses.asdict(hp)["train"]["remat"] == "dots"
