"""The port's numpy surface that its first copies left out, each function
against the JAX package's on the same seeded input, on the CPU: the
spectrogram, both Griffin-Lim loops and the inversions built on them, the
round-trip report, MFCCs and the endpoint search of ``audio/dsp.py``; the
basic and transliteration cleaners; ``CharTokenizer.decode`` and
``TestUtils.ids_to_text``; ``batch_diagonality``; ``HParams.replace`` and
``tiny_test_config``; and ``set_global_determinism``, which the training
CLI runs before it builds anything.

Both sides are numpy (or Python) code doing the same arithmetic in the same
order, so they are held equal, or to 1e-6 where a float32 path might sum in
another order. The audio runs at the small config of
tests/test_torch_audio.py: 129 bins, 32-sample hops.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401

from vaenar_tts_tpu.audio import dsp as jax_dsp
from vaenar_tts_tpu.audio import export as jax_export
from vaenar_tts_tpu.cli import train as jax_train_cli
from vaenar_tts_tpu.configs import hparams as jax_hparams
from vaenar_tts_tpu.text import cleaners as jax_cleaners
from vaenar_tts_tpu.text import tokenizer as jax_tokenizer
from vaenar_tts_tpu.utils import metrics as jax_metrics
from vaenar_tts_torch.audio import dsp
from vaenar_tts_torch.audio import export
from vaenar_tts_torch.cli import train as train_cli
from vaenar_tts_torch.configs import hparams
from vaenar_tts_torch.text import cleaners
from vaenar_tts_torch.text import tokenizer
from vaenar_tts_torch.utils import metrics


@pytest.fixture(scope="module")
def processors():
    """(the JAX package's AudioProcessor, the port's) at the small config."""
    base = dataclasses.replace(jax_hparams.get_config("ljspeech").audio, num_freq=129,
                               frame_length_sample=128, frame_shift_sample=32,
                               griffin_lim_iters=8)
    port = hparams.AudioConfig(**{f.name: getattr(base, f.name)
                                  for f in dataclasses.fields(hparams.AudioConfig)})
    return jax_dsp.AudioProcessor(base), dsp.AudioProcessor(port)


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050
    return (0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


def test_port_audio_config_has_every_jax_audio_field():
    port = {f.name for f in dataclasses.fields(hparams.AudioConfig)}
    assert port == {f.name for f in dataclasses.fields(jax_hparams.AudioConfig)}


@pytest.mark.parametrize("clip_norm", [True, False])
def test_spectrogram_matches_jax(processors, clip_norm):
    ref, port = processors
    y = _signal(3000, 0)
    np.testing.assert_array_equal(port.spectrogram(y, clip_norm), ref.spectrogram(y, clip_norm))


@pytest.mark.parametrize("loop", ["griffin_lim", "griffin_lim_fast"])
def test_griffin_lim_loops_match_jax(processors, loop):
    ref, port = processors
    S = np.abs(ref._stft(_signal(2000, 1)))
    got = getattr(port, loop)(S, np.random.default_rng(5))
    want = getattr(ref, loop)(S, np.random.default_rng(5))
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("inversion,forward", [("inv_spectrogram", "spectrogram"),
                                               ("inv_mel_spectrogram", "melspectrogram")])
def test_inversions_match_jax(processors, inversion, forward, fast):
    ref, port = processors
    spec = getattr(ref, forward)(_signal(2000, 2))
    got = getattr(port, inversion)(spec, np.random.default_rng(6), fast=fast)
    want = getattr(ref, inversion)(spec, np.random.default_rng(6), fast=fast)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_inv_mel_spectrogram_defaults_to_the_fast_loop(processors):
    _, port = processors
    mel = port.melspectrogram(_signal(2000, 3))
    np.testing.assert_array_equal(port.inv_mel_spectrogram(mel, np.random.default_rng(7)),
                                  port.inv_mel_spectrogram(mel, np.random.default_rng(7),
                                                           fast=True))


@pytest.mark.parametrize("clip_norm", [True, False])
def test_roundtrip_report_matches_jax(processors, capsys, clip_norm):
    ref, port = processors
    y = _signal(3000, 4)
    got = port.roundtrip_report(y, clip_norm)
    printed = capsys.readouterr().out
    assert got == ref.roundtrip_report(y, clip_norm)
    assert printed == capsys.readouterr().out


def test_mfcc_matches_jax(processors):
    ref, port = processors
    y = _signal(4000, 5)
    got = port.mfcc(y)
    assert got.shape[0] == 3 * port.cfg.n_mfcc
    np.testing.assert_allclose(got, ref.mfcc(y), rtol=0, atol=1e-6)


@pytest.mark.parametrize("silence_at", [None, 9000, 20000])
def test_find_endpoint_matches_jax(processors, silence_at):
    ref, port = processors
    y = _signal(30000, 6)
    if silence_at is not None:
        y[silence_at:] = 0.0
    got = port.find_endpoint(y, min_silence_sec=0.2)
    assert got == ref.find_endpoint(y, min_silence_sec=0.2)
    assert (got == len(y)) == (silence_at is None)


TEXTS = ["  Hello,   World!  ", "Ünïcödé — Café\tnaïve", "MIXED case\n\nlines 42"]


@pytest.mark.parametrize("name", ["basic_cleaners", "transliteration_cleaners"])
@pytest.mark.parametrize("text", TEXTS)
def test_cleaners_match_jax(name, text):
    assert getattr(cleaners, name)(text) == getattr(jax_cleaners, name)(text)


@pytest.mark.parametrize("strip", [False, True])
def test_decode_and_ids_to_text_match_jax(tmp_path, strip):
    port_hp, ref_hp = hparams.get_config("ljspeech"), jax_hparams.get_config("ljspeech")
    port_tok, ref_tok = tokenizer.CharTokenizer(port_hp.text), jax_tokenizer.CharTokenizer(ref_hp.text)
    ids = port_tok.encode_english("The quick brown fox, 1984.")
    assert ids == ref_tok.encode_english("The quick brown fox, 1984.")
    padded = np.array(ids + [0, 0, 0], dtype=np.int64)
    assert port_tok.decode(padded, strip) == ref_tok.decode(padded, strip)
    if not strip:
        port_utils = export.TestUtils(port_hp, str(tmp_path / "port"), device="cpu")
        ref_utils = jax_export.TestUtils(ref_hp, str(tmp_path / "jax"))
        assert port_utils.ids_to_text(padded) == ref_utils.ids_to_text(padded)
        assert port_utils.ids_to_text(padded).startswith("^the quick brown fox")


@pytest.mark.parametrize("n_valid", [None, 2])
def test_batch_diagonality_matches_jax(n_valid):
    rng = np.random.default_rng(8)
    ali = rng.random((3, 2, 40, 12)).astype(np.float32)
    ali /= ali.sum(-1, keepdims=True)
    mel_lens, text_lens = [40, 31, 17], [12, 9, 5]
    got = metrics.batch_diagonality(ali, mel_lens, text_lens, n_valid)
    want = jax_metrics.batch_diagonality(ali, mel_lens, text_lens, n_valid)
    assert got == want
    assert got["n"] == (3 if n_valid is None else 2)


def _port_fields(port_hp, ref_hp):
    """{section: {field: (port value, JAX value)}} over the port's fields."""
    out = {}
    for section in dataclasses.fields(port_hp):
        p, r = getattr(port_hp, section.name), getattr(ref_hp, section.name)
        if not dataclasses.is_dataclass(p):
            out[section.name] = {"": (p, r)}
            continue
        out[section.name] = {f.name: (getattr(p, f.name), getattr(r, f.name))
                             for f in dataclasses.fields(p)}
    return out


def test_tiny_test_config_matches_jax():
    port_hp, ref_hp = hparams.tiny_test_config(), jax_hparams.tiny_test_config()
    for section, fields in _port_fields(port_hp, ref_hp).items():
        for name, (p, r) in fields.items():
            assert p == r, f"{section}.{name}: {p!r} != {r!r}"
    assert not hasattr(port_hp.train, "use_pallas_attention")
    assert hparams.tiny_test_config(vocab_size=39).encoder.vocab_size == 39


def test_hparams_replace_matches_jax():
    port_hp = hparams.get_config("ljspeech").replace(
        name="x", common=hparams.CommonConfig(latent_dim=16))
    ref_hp = jax_hparams.get_config("ljspeech").replace(
        name="x", common=jax_hparams.CommonConfig(latent_dim=16))
    for section, fields in _port_fields(port_hp, ref_hp).items():
        for name, (p, r) in fields.items():
            assert p == r, f"{section}.{name}"
    assert hparams.get_config("ljspeech").name == "ljspeech"  # a copy, not in place


def _draws():
    return random.random(), float(np.random.rand()), float(torch.rand(()))


def test_set_global_determinism_matches_jax_and_seeds_torch():
    train_cli.set_global_determinism(1234)
    got = _draws()
    jax_train_cli.set_global_determinism(1234)
    want = _draws()
    assert got[:2] == want[:2]  # Python's and numpy's, as the JAX package seeds them
    train_cli.set_global_determinism(1234)
    assert _draws() == got  # torch's too


def test_train_cli_seeds_before_it_builds_anything(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(train_cli, "set_global_determinism", lambda seed: calls.append(seed))
    monkeypatch.setattr(train_cli, "train", lambda hp, *a, **k: calls.append("train"))
    train_cli.main(["--dataset", "ljspeech", "--data_dir", str(tmp_path / "rec"),
                    "--model_dir", str(tmp_path / "ckpt"), "--log_dir", str(tmp_path / "logs"),
                    "--device", "cpu", "--override", "train.random_seed=77"])
    assert calls == [77, "train"]
