"""The port's mel frontend (``vaenar_tts_torch.ops.stft``) and its numpy
copies (``audio/dsp.py``, ``utils/metrics.py``) against the JAX package's,
on the CPU, at the small audio config of tests/test_griffin_lim.py.

Tolerances: magnitudes and normalized mels atol 2e-4 and preemphasis 1e-5,
as tests/test_jax_dsp.py holds the JAX frontend to the numpy DSP (fp32
against the float64 reference); a ragged batch against its items alone
1e-5 (the same fp32 arithmetic, batched); the numpy copies exactly, or to
1e-6 where a float64 FFT sums in another order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaenar_tts_tpu.audio import dsp as jax_dsp
from vaenar_tts_tpu.configs import get_config
from vaenar_tts_tpu.ops import stft as jax_stft
from vaenar_tts_tpu.utils import metrics as jax_metrics
from vaenar_tts_torch.audio import dsp
from vaenar_tts_torch.configs.hparams import AudioConfig
from vaenar_tts_torch.ops import stft
from vaenar_tts_torch.utils import metrics


@pytest.fixture(scope="module")
def cfgs():
    """(the JAX package's config, the port's) at the small audio config."""
    base = dataclasses.replace(get_config("ljspeech").audio, num_freq=129,
                               frame_length_sample=128, frame_shift_sample=32,
                               griffin_lim_iters=16)
    port = AudioConfig(**{f.name: getattr(base, f.name) for f in dataclasses.fields(AudioConfig)})
    return base, port


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050
    return (0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


def test_preemphasis_matches_jax_and_scipy(cfgs):
    cfg, _ = cfgs
    y = _signal(3000, 0)
    got = stft.preemphasis(torch.from_numpy(y), cfg.preemphasize).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_stft.preemphasis(jnp.asarray(y),
                                                                    cfg.preemphasize)),
                               atol=1e-5)
    np.testing.assert_allclose(got, jax_dsp.AudioProcessor(cfg).preemphasize(y), atol=1e-5)


@pytest.mark.parametrize("n", [3000, 3008])  # a length off the hop grid, and one on it
def test_stft_magnitude_and_mel_match_jax(cfgs, n):
    cfg, port_cfg = cfgs
    ap = jax_dsp.AudioProcessor(cfg)
    y = np.stack([_signal(n, 1), _signal(n, 2)])
    mag = stft.batched_stft_magnitude(torch.from_numpy(y), cfg.n_fft, cfg.frame_shift_sample,
                                      cfg.frame_length_sample).numpy()
    assert mag.shape[1] == 1 + n // cfg.frame_shift_sample
    mag_jax = np.asarray(jax_stft.batched_stft_magnitude(
        jnp.asarray(y), cfg.n_fft, cfg.frame_shift_sample, cfg.frame_length_sample))
    np.testing.assert_allclose(mag, mag_jax, atol=2e-4)
    np.testing.assert_allclose(mag[1], np.abs(ap._stft(y[1])).T, atol=2e-4)
    mel = stft.batched_melspectrogram(torch.from_numpy(y), port_cfg).numpy()
    np.testing.assert_allclose(mel, np.asarray(jax_stft.batched_melspectrogram(
        jnp.asarray(y), cfg)), atol=2e-4)
    np.testing.assert_allclose(mel[0], ap.melspectrogram(ap.preemphasize(y[0])).T, atol=2e-4)


def test_ragged_batch_matches_items(cfgs):
    """Items of 2100 and 3000 samples, each preemphasized and reflect-padded
    alone and zero-padded to one batch (the JAX package's ragged recipe),
    against each item's mel alone."""
    _, cfg = cfgs
    ys = [_signal(2100, 3), _signal(3000, 4)]
    n_fft, hop = cfg.n_fft, cfg.frame_shift_sample
    padded = [np.pad(stft.preemphasis(torch.from_numpy(y), cfg.preemphasize).numpy(),
                     n_fft // 2, mode="reflect") for y in ys]
    batch = np.zeros((2, max(map(len, padded))), np.float32)
    for i, p in enumerate(padded):
        batch[i, :len(p)] = p
    both = stft.batched_melspectrogram(torch.from_numpy(batch), cfg, apply_preemphasis=False,
                                       center=False).numpy()
    for i, y in enumerate(ys):
        alone = stft.batched_melspectrogram(torch.from_numpy(y), cfg).numpy()[0]
        assert alone.shape[0] == 1 + len(y) // hop
        np.testing.assert_allclose(both[i, :alone.shape[0]], alone, atol=1e-5)


def test_dsp_copy_matches_original(cfgs):
    cfg, port_cfg = cfgs
    y = _signal(2500, 5)
    ours, theirs = dsp.AudioProcessor(port_cfg), jax_dsp.AudioProcessor(cfg)
    np.testing.assert_array_equal(ours.mel_basis(), theirs.mel_basis())
    np.testing.assert_array_equal(ours.melspectrogram(y), theirs.melspectrogram(y))
    np.testing.assert_array_equal(ours.preemphasize(y), theirs.preemphasize(y))
    mel = theirs.melspectrogram(theirs.preemphasize(y))
    np.testing.assert_array_equal(ours.inv_mel_spectrogram(mel, np.random.default_rng(1)),
                                  theirs.inv_mel_spectrogram(mel, np.random.default_rng(1)))
    np.testing.assert_array_equal(ours.inv_preemphasize(y), theirs.inv_preemphasize(y))
    spec = theirs._stft(y)
    np.testing.assert_allclose(ours._istft(spec), theirs._istft(spec), atol=1e-6)
    np.testing.assert_array_equal(dsp.nola_inverse(dsp.hann_window(128), 32, 20),
                                  jax_dsp.nola_inverse(jax_dsp.hann_window(128), 32, 20))


def test_metrics_copy_matches_original():
    rng = np.random.default_rng(6)
    a, b = rng.uniform(0, 1, (37, 80)), rng.uniform(0, 1, (41, 80))
    for name in ("mel_l1", "mel_l2", "mcd", "mcd_dtw"):
        assert getattr(metrics, name)(a, b) == getattr(jax_metrics, name)(a, b)
    takes = [rng.uniform(0, 1, (n, 80)) for n in (30, 33, 29)]
    idx, d = metrics.medoid_take(takes)
    idx_jax, d_jax = jax_metrics.medoid_take(takes)
    assert idx == idx_jax
    np.testing.assert_array_equal(d, d_jax)
    ali = rng.dirichlet(np.ones(12), size=(2, 25))
    assert (metrics.alignment_diagonality(ali, 20, 10)
            == jax_metrics.alignment_diagonality(ali, 20, 10))
