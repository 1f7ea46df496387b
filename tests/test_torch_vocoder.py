"""The port's neural ISTFT-head vocoder (``models/vocoder.py``,
``training/vocoder.py``) against the JAX package's, on the CPU, at the
small audio config of tests/test_griffin_lim.py and a tiny width, from the
same weights (a flax tree of random leaves, carried over by
``interop.weights.vocoder_from_jax``):

* the forward's spectra and waveforms (``spec_to_wav``): fp32 within 1e-4
  of the largest element; in bf16 both frameworks' outputs are held to the
  JAX fp32 ones, and the port's error (largest and root mean square) is at
  most 2 times JAX's own (see the test for why not elementwise);
* ``multires_stft_loss`` of the predicted waveforms and its gradient in
  every parameter against ``jax.value_and_grad``: the loss within 1e-5
  relative, each gradient leaf within 1e-3 of its largest element;
* one Adam step of ``vocoder_train_step`` against optax's ``adam``: each
  update within 1e-3 · lr where |g| > 1e-5 (a full ±lr step on both
  sides; the elements whose update follows g / eps are left out);
* ``PairSampler`` draws the JAX package's crops exactly, from the same toy
  utterances, which the port's ``toy_utterances`` renders as the JAX
  package's do (exactly);
* the oracle spectrum of a tone comes back through ``spec_to_wav`` within
  2e-3, the phasor head's magnitudes are exp(clipped log-magnitude), and
  the host ISTFT agrees with the device one within 2e-4 (JAX's
  tests/test_vocoder.py bounds);
* a run resumes from its saved step; a vocoder trained under another
  audio config fails at once in ``TestUtils``; a JAX vocoder directory
  (Orbax step directories and ``vocoder_config.json``) is refused with
  ``ForeignCheckpointError`` and left untouched.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vaenar_tts_tpu.audio.dsp import stft as jax_np_stft
from vaenar_tts_tpu.configs import get_config as jax_get_config
from vaenar_tts_tpu.models import vocoder as jvoc
from vaenar_tts_tpu.training import vocoder as jtrain
from vaenar_tts_torch.audio.export import TestUtils
from vaenar_tts_torch.configs.hparams import AudioConfig, HParams
from vaenar_tts_torch.interop.weights import flatten, torch_to_jax, vocoder_from_jax
from vaenar_tts_torch.models import vocoder as voc
from vaenar_tts_torch.training import vocoder as train_voc
from vaenar_tts_torch.utils.checkpoint import ForeignCheckpointError

from test_torch_modules import randomize

SMALL = dict(num_freq=129, frame_length_sample=128, frame_shift_sample=32)
TINY = dict(hidden=32, n_blocks=2, mlp_ratio=2, segment_frames=24, batch_size=2,
            learning_rate=5e-3, stft_loss_scales=((128, 32, 128), (256, 64, 256)))
FP32_TOL = 1e-4
BF16_RATIO = 2.0
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def audio():
    jax_audio = dataclasses.replace(jax_get_config("ljspeech").audio, **SMALL)
    port = AudioConfig(**{f.name: getattr(jax_audio, f.name)
                          for f in dataclasses.fields(AudioConfig)})
    return jax_audio, port


def configs(dtype="float32", **extra):
    kw = dict(TINY, compute_dtype=dtype, **extra)
    return jvoc.VocoderConfig(**kw), voc.VocoderConfig(**kw)


def pair(audio, dtype="float32", seed=3):
    """(JAX model, params, port model) from one random flax tree."""
    jcfg, cfg = configs(dtype)
    model = voc.MelVocoder(cfg, audio[1])
    params = randomize(torch_to_jax(model)[0], np.random.default_rng(seed))
    vocoder_from_jax(model, params)
    return jvoc.MelVocoder(jcfg, audio[0]), params, model


def mels(audio, b=2, t=24, seed=0):
    return np.random.default_rng(seed).random((b, t, audio[1].num_mels)).astype(np.float32)


def _tone(sample_rate, dur, f=440.0):
    t = np.arange(int(dur * sample_rate)) / sample_rate
    return (0.5 * np.sin(2 * np.pi * f * t) + 0.2 * np.sin(4 * np.pi * f * t)).astype(np.float32)


def _forward(audio, dtype, mel):
    """((JAX spectra, JAX wavs), (port spectra, port wavs)) in ``dtype``,
    all numpy fp32, from the same weights at every dtype."""
    jmodel, params, model = pair(audio, dtype)
    jspec = jmodel.apply({"params": params}, jnp.asarray(mel))
    spec = model(torch.from_numpy(mel))
    assert spec.dtype == torch.float32 and tuple(spec.shape) == jspec.shape
    return ((np.asarray(jspec), np.asarray(jvoc.spec_to_wav(jspec, audio[0]))),
            (spec.detach().numpy(), voc.spec_to_wav(spec, audio[1]).detach().numpy()))


def test_forward_matches_jax_fp32(audio):
    mel = mels(audio)
    (jspec, jwav), (spec, wav) = _forward(audio, "float32", mel)
    assert wav.shape == jwav.shape == (2, 32 * 23)
    for got, want in ((spec, jspec), (wav, jwav)):
        assert np.abs(got - want).max() <= FP32_TOL * np.abs(want).max()


def test_forward_bf16_is_as_close_to_fp32_as_jax(audio):
    """bf16 rounds the convolutions, norms and MLP, and the phasor head
    divides by |(re, im)|, which is small for some bins, so one bf16 ulp
    there turns a bin's phase: neither framework's bf16 spectra are near
    its fp32 ones elementwise (the two round GELU differently). The port's
    bf16 error against JAX's fp32 forward, in the largest element and in
    the root mean square, stays within 2 times JAX's own bf16 error."""
    mel = mels(audio)
    ref = _forward(audio, "float32", mel)[0]
    jax16, port16 = _forward(audio, "bfloat16", mel)
    for want, jgot, got in zip(ref, jax16, port16):
        for norm in (lambda e: np.abs(e).max(), lambda e: np.sqrt(np.mean(e ** 2))):
            jerr, err = norm(jgot - want), norm(got - want)
            assert 0 < jerr and err <= BF16_RATIO * jerr, (err, jerr)


@pytest.fixture(scope="module")
def grad_case(audio):
    """The JAX side of one training step at fp32: (params, mel, target,
    loss, grads, optax's Adam updates), from one jitted value_and_grad."""
    jmodel, params, _ = pair(audio)
    jcfg, _ = configs()
    mel = mels(audio, seed=1)
    target = np.random.default_rng(2).standard_normal((2, 32 * 23)).astype(np.float32) * 0.3

    def jloss(p):
        pred = jvoc.spec_to_wav(jmodel.apply({"params": p}, jnp.asarray(mel)), audio[0])
        return jtrain.multires_stft_loss(pred, jnp.asarray(target), jcfg.stft_loss_scales)

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    opt = optax.adam(jcfg.learning_rate, b1=jcfg.adam_b1, b2=jcfg.adam_b2)
    updates, _ = opt.update(jgrads, opt.init(params), params)
    as_np = lambda t: flatten(jax.tree_util.tree_map(np.asarray, t))  # noqa: E731
    return params, mel, target, float(jval), as_np(jgrads), as_np(updates)


def test_loss_and_gradients_match_jax(audio, grad_case):
    params, mel, target, jval, want, _ = grad_case
    _, _, model = pair(audio)
    loss = train_voc.vocoder_loss(model, torch.from_numpy(mel), torch.from_numpy(target))
    loss.backward()
    assert abs(loss.item() - jval) <= LOSS_RTOL * abs(jval)
    grads = flatten(torch_to_jax(model, {n: p.grad for n, p in model.named_parameters()})[0])
    assert sorted(grads) == sorted(want)
    for key, g in want.items():
        err = np.abs(grads[key] - g).max()
        assert err <= GRAD_TOL * np.abs(g).max(), (key, err, np.abs(g).max())


def test_adam_step_matches_optax(audio, grad_case):
    params, mel, target, _, g_jax, want = grad_case
    _, cfg = configs()
    _, _, model = pair(audio)
    train_voc.vocoder_train_step(model, train_voc.make_vocoder_optimizer(cfg, model),
                                 torch.from_numpy(mel), torch.from_numpy(target))
    before, after = flatten(params), flatten(torch_to_jax(model)[0])
    lr = cfg.learning_rate
    left_out = total = 0
    for key, u in want.items():
        big = np.abs(g_jax[key]) > 1e-5
        err = np.abs(after[key].astype(np.float64) - before[key] - u)
        tol = 1e-3 * lr + 0.5 * np.spacing(np.abs(after[key]))
        assert np.all(err[big] <= tol[big]), (key, err[big].max() / lr)
        assert np.all(np.abs(after[key] - before[key])[big] >= 0.9 * lr), key
        left_out += int((~big).sum())
        total += big.size
    assert left_out < 0.1 * total


def test_pair_sampler_draws_jax_crops(audio):
    jutts = jtrain.toy_utterances(audio[0], n=3, seed=7, version=2)
    utts = train_voc.toy_utterances(audio[1], n=3, seed=7, version=2)
    assert all(np.array_equal(a, b) for a, b in zip(utts, jutts))
    jsamp = jtrain.PairSampler(jutts, audio[0], 24, seed=11)
    samp = train_voc.PairSampler(utts, audio[1], 24, seed=11)
    for _ in range(3):
        (jm, jw), (m, w) = jsamp.sample(4), samp.sample(4)
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(w, jw)


def test_oracle_spectrum_unit_phasor_and_host_istft(audio):
    y = _tone(audio[1].sample_rate, 0.3)
    S = jax_np_stft(y, audio[1].n_fft, 32, 128)
    spec_ri = np.concatenate([S.real, S.imag], axis=0)[None].astype(np.float32)
    wav = voc.spec_to_wav(torch.from_numpy(spec_ri), audio[1])[0].numpy()
    n = min(len(wav), len(y))
    np.testing.assert_allclose(wav[:n], y[:n], atol=2e-3)

    _, _, model = pair(audio, seed=8)
    spec = model(torch.from_numpy(mels(audio, seed=9)))
    n_bins = spec.shape[1] // 2
    mag = torch.sqrt(spec[:, :n_bins] ** 2 + spec[:, n_bins:] ** 2)
    assert mag.max().item() <= np.exp(model.cfg.log_magnitude_clip) * 1.001
    assert (mag > 0).all()
    device = voc.vocode(model, torch.from_numpy(mels(audio, seed=9))).numpy()
    host = voc.vocode(model, torch.from_numpy(mels(audio, seed=9)), istft_on_device=False)
    assert device.shape == host.shape
    np.testing.assert_allclose(device, host, atol=2e-4)


def _train(audio, model_dir, steps, **extra):
    _, cfg = configs(steps=steps, **extra)
    sampler = train_voc.PairSampler([_tone(audio[1].sample_rate, 0.5)], audio[1], 24, seed=0)
    return train_voc.train_vocoder(cfg, audio[1], sampler, str(model_dir), log_every=1,
                                   save_every=100, device="cpu")


def test_resume_continues_from_saved_step(audio, tmp_path, capsys):
    _, first = _train(audio, tmp_path / "v", 2)
    assert first["start"] == 0 and sorted(first["losses"]) == [1, 2]
    model, second = _train(audio, tmp_path / "v", 4)
    assert second["start"] == 2 and sorted(second["losses"]) == [3, 4]
    assert "vocoder: resumed from step 2" in capsys.readouterr().out
    loaded, step = voc.load_vocoder(str(tmp_path / "v"), "cpu")
    assert step == 4
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v)


def test_mismatched_audio_config_fails_fast(audio, tmp_path):
    _train(audio, tmp_path / "v", 1)
    hp = dataclasses.replace(HParams(), audio=dataclasses.replace(audio[1], sample_rate=16000))
    with pytest.raises(ValueError, match="different audio config"):
        TestUtils(hp, str(tmp_path / "out"), "cpu", neural_vocoder_dir=str(tmp_path / "v"))
    TestUtils(dataclasses.replace(HParams(), audio=audio[1]), str(tmp_path / "out"), "cpu",
              neural_vocoder_dir=str(tmp_path / "v"))


def _snapshot(root):
    return {os.path.relpath(os.path.join(d, f), root): os.path.getmtime(os.path.join(d, f))
            for d, _, files in os.walk(root) for f in files}


def test_jax_vocoder_dir_is_refused_untouched(audio, tmp_path):
    root = tmp_path / "jax_vocoder"
    for step in ("2000", "4000"):
        (root / step / "default").mkdir(parents=True)
        (root / step / "default" / "checkpoint").write_bytes(b"orbax")
    jvoc.save_vocoder_config(str(root), configs()[0], audio[0])
    before = _snapshot(root)
    with pytest.raises(ForeignCheckpointError, match="jax_vocoder"):
        voc.load_vocoder(str(root), "cpu")
    with pytest.raises(ForeignCheckpointError):
        _train(audio, root, 1)
    with pytest.raises(ForeignCheckpointError):
        TestUtils(dataclasses.replace(HParams(), audio=audio[1]), str(tmp_path / "out"), "cpu",
                  neural_vocoder_dir=str(root))
    assert _snapshot(root) == before
