"""The port's dev step and data-dependent flow init against the JAX
package's, on the tiny model and batch of test_torch_train_step.py.

* ``dev_step`` (dropout off, BatchNorm on running statistics, per-example
  losses averaged over the valid rows, kl unclamped) with the posterior
  noise injected on both sides: every metric to 1e-5 relative.
* ``run_data_dependent_init`` with the same base noise on both sides (the
  JAX prior's ``_initial_sample`` is patched to return it): the ActNorm
  parameters it sets agree to 1e-4; every other parameter, and every
  BatchNorm running statistic, is left as it was, as the JAX package keeps
  only the pass's ``flow_init``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaenar_tts_tpu.models import vaenar as jvaenar
from vaenar_tts_tpu.models.prior import LOG_2PI, TransformerPrior as JaxPrior
from vaenar_tts_tpu.training.steps import make_dev_step, run_data_dependent_init as jax_init
from vaenar_tts_torch.interop.weights import flatten, torch_to_jax
from vaenar_tts_torch.training import steps

from test_torch_train_step import (B, KL_WEIGHT, MEL, R, batch, hparams_from_dict,
                                   hparams_to_dict, inject, port_model,
                                   random_variables, tiny_hparams)

VALID = np.asarray([1.0, 0.0], np.float32)  # the second row is repeat padding


@pytest.fixture(scope="module")
def setup():
    hp = tiny_hparams()
    params, stats = random_variables(hp, seed=33)
    return hp, params, stats, batch(5)


def test_dev_step_matches_jax(setup):
    hp, params, stats, (texts, mels, t_lens, m_lens) = setup
    eps = np.random.default_rng(6).standard_normal(
        (B, 1, MEL // R, hp.common.latent_dim)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        inject(mp, eps)
        want = make_dev_step(hp, jvaenar.VAENAR(hp))(
            params, stats, texts, mels, t_lens, m_lens, jnp.float32(KL_WEIGHT),
            jnp.asarray(VALID), jax.random.key(0), reduction_factor=R)
    model = port_model(hp, params, stats)
    got = steps.dev_step(
        model, hparams_from_dict(hparams_to_dict(hp)), torch.from_numpy(texts).long(),
        torch.from_numpy(mels), torch.from_numpy(t_lens), torch.from_numpy(m_lens),
        KL_WEIGHT, torch.from_numpy(VALID), R, epsilon=torch.from_numpy(eps))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5,
                                   err_msg=key)


def test_data_dependent_init_matches_jax(setup):
    hp, params, stats, (texts, mels, t_lens, m_lens) = setup
    r = hp.common.max_reduction_factor
    eps = np.random.default_rng(7).standard_normal(
        (B, MEL // r, hp.common.latent_dim)).astype(np.float32)

    def fixed_noise(self, targets_lengths, max_length, temperature=1.0):
        e = jnp.asarray(eps) * temperature
        mask = (jnp.arange(max_length)[None] < targets_lengths[:, None])[..., None]
        return e, jnp.sum(mask * -0.5 * (LOG_2PI + e ** 2), axis=(1, 2))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxPrior, "_initial_sample", fixed_noise)
        want = jax_init(hp, jvaenar.VAENAR(hp), params, stats, texts, t_lens,
                        m_lens, max_mel_length=MEL)
    model = port_model(hp, params, stats)
    stats_before = {n: b.clone() for n, b in model.named_buffers()}
    steps.run_data_dependent_init(
        model, torch.from_numpy(texts).long(), torch.from_numpy(t_lens),
        torch.from_numpy(m_lens), MEL, epsilon=torch.from_numpy(eps))
    got_params, _ = torch_to_jax(model)
    want, got, before = flatten(want), flatten(got_params), flatten(params)
    n_actnorm = 0
    for key in want:
        if "/actnorm_" in key:
            n_actnorm += 1
            np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=1e-4,
                                       rtol=1e-4, err_msg=key)
            assert not np.allclose(got[key], before[key])
        else:
            np.testing.assert_array_equal(got[key], before[key], err_msg=key)
    assert n_actnorm == 2 * hp.prior.n_blk
    for name, b in model.named_buffers():
        assert torch.equal(b, stats_before[name]), name
