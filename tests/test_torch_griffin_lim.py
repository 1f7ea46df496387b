"""The port's Griffin-Lim (``vaenar_tts_torch.ops.griffin_lim``) and its
streaming vocoder against the JAX package's, on the CPU, at the small
audio config of tests/test_griffin_lim.py.

Both sides start from the same phase: the one ``jax.random.uniform`` draws
for the JAX function, handed to the port as ``init_phase``. Tolerances:
waveforms atol 1e-4 (fp32 FFTs in another order than XLA's DFT matmul,
over a few iterations; peaks are ~0.6), the streaming window's converged
phases times their magnitudes to 1e-4 of the largest magnitude (the phase
of a bin whose spectrum is near 0 turns with the rounding, and its
magnitude is what carries it into the next window), and the device
streaming backend against the host one at the correlation bound of
tests/test_streaming.py, 0.95.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaenar_tts_tpu.audio.dsp import AudioProcessor as JaxAudioProcessor
from vaenar_tts_tpu.configs import get_config
from vaenar_tts_tpu.ops.griffin_lim import gl_window_fn, griffin_lim_jax, mel_to_wav_jax
from vaenar_tts_torch.audio.dsp import AudioProcessor
from vaenar_tts_torch.audio.streaming import StreamingVocoder
from vaenar_tts_torch.configs.hparams import AudioConfig
from vaenar_tts_torch.ops import griffin_lim


@pytest.fixture(scope="module")
def cfgs():
    base = dataclasses.replace(get_config("ljspeech").audio, num_freq=129,
                               frame_length_sample=128, frame_shift_sample=32,
                               griffin_lim_iters=16)
    port = AudioConfig(**{f.name: getattr(base, f.name) for f in dataclasses.fields(AudioConfig)})
    return base, port


def _tones(cfg, dur):
    t = np.arange(int(dur * cfg.sample_rate)) / cfg.sample_rate
    return (0.5 * np.sin(2 * np.pi * 440 * t) + 0.25 * np.sin(2 * np.pi * 990 * t)
            ).astype(np.float32)


def _jax_phase(key, shape):
    return np.array(jax.random.uniform(key, shape, minval=0.0, maxval=2.0 * np.pi))


def test_griffin_lim_matches_jax_from_its_phase(cfgs):
    cfg, port_cfg = cfgs
    ap = JaxAudioProcessor(cfg)
    mags = np.stack([np.abs(ap._stft(_tones(cfg, 0.25) * s)).T for s in (1.0, 0.3)])
    mags = mags.astype(np.float32)  # [2, F, bins]
    key = jax.random.key(0)
    want = np.asarray(griffin_lim_jax(jnp.asarray(mags), cfg, key, n_iters=4))
    phase = _jax_phase(key, (2, mags.shape[2], mags.shape[1]))
    got = griffin_lim.griffin_lim(torch.from_numpy(mags), port_cfg,
                                  init_phase=torch.from_numpy(phase), n_iters=4)
    assert got.shape == want.shape == (2, cfg.frame_shift_sample * (mags.shape[1] - 1))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_mel_to_wav_matches_jax(cfgs):
    cfg, port_cfg = cfgs
    ap = JaxAudioProcessor(cfg)
    mel = ap.melspectrogram(ap.preemphasize(_tones(cfg, 0.3))).T[None].astype(np.float32)
    key = jax.random.key(1)
    want = np.asarray(mel_to_wav_jax(jnp.asarray(mel), cfg, key))
    phase = _jax_phase(key, (1, cfg.num_freq, mel.shape[1]))
    got = griffin_lim.mel_to_wav(torch.from_numpy(mel), port_cfg,
                                 init_phase=torch.from_numpy(phase)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    with pytest.raises(ValueError, match="Generator"):
        griffin_lim.mel_to_wav(torch.from_numpy(mel), port_cfg)


def test_window_matches_gl_window_fn_with_padding(cfgs):
    """A window of 40 frames of which 31 are valid: the signal and the
    converged phases against the JAX window function."""
    cfg, _ = cfgs
    ap = JaxAudioProcessor(cfg)
    n_fft, hop, win = cfg.n_fft, cfg.frame_shift_sample, cfg.frame_length_sample
    mag = np.abs(ap._stft(_tones(cfg, 0.06))).T.astype(np.float32)[:31]
    mag = np.pad(mag, ((0, 9), (0, 0)))
    init = np.exp(2j * np.pi * np.random.default_rng(2).random(mag.shape)).astype(np.complex64)
    y_jax, re_jax, im_jax = gl_window_fn(n_fft, hop, win, 40, 4)(
        mag, init.real.copy(), init.imag.copy(), 31)
    y, fin = griffin_lim.gl_window(torch.from_numpy(mag), torch.from_numpy(init), 31,
                                   n_fft, hop, win, 4)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), atol=1e-4)
    # the phase of a bin is what its magnitude carries into the next window
    want = mag * (np.asarray(re_jax) + 1j * np.asarray(im_jax))
    np.testing.assert_allclose(mag * fin.numpy(), want, atol=1e-4 * mag.max())
    assert np.all(fin[31:].numpy() == 0)


def test_streaming_device_backend_matches_host(cfgs):
    """The device backend, on the CPU here, against the host backend from
    the same seed: equal lengths and a correlation above 0.95."""
    _, port_cfg = cfgs
    ap = AudioProcessor(port_cfg)
    mel = ap.melspectrogram(ap.preemphasize(_tones(port_cfg, 0.6))).T
    host = StreamingVocoder(ap, chunk_frames=64, context_frames=8)
    dev = StreamingVocoder(ap, chunk_frames=64, context_frames=8, backend="device",
                           device="cpu")
    wh = host.synthesize(mel, np.random.default_rng(3))
    wd = dev.synthesize(mel, np.random.default_rng(3))
    assert len(wh) == len(wd) == port_cfg.frame_shift_sample * (mel.shape[0] - 1)
    assert np.corrcoef(wh, wd)[0, 1] > 0.95
