"""The port's toy corpus and letter decoder against the JAX package's
(``data/toy.py``), on the CPU. Both are numpy, so the same seed must give
the same texts, waveforms and transcripts: the shards' fids and texts are
equal and their mels agree within 1e-6 (the same float32 DSP), as do the
decoder's templates; ``letter_error_rate`` and ``random_text`` are equal
case by case. The corpus is written at the shipped 22.05 kHz config, the
one the decoder is built for."""

import os

import numpy as np
import pytest

from vaenar_tts_tpu.audio.dsp import AudioProcessor as JaxAudioProcessor
from vaenar_tts_tpu.configs import get_config as jax_get_config
from vaenar_tts_tpu.data import toy as jax_toy
from vaenar_tts_torch.configs.hparams import get_config
from vaenar_tts_torch.data import toy
from vaenar_tts_torch.data.records import RecordShardReader, list_shards

ATOL = 1e-6


def _shards(save_dir):
    out = {}
    for mode in ("train", "dev", "test"):
        for path in list_shards(save_dir, mode):
            r = RecordShardReader(path)
            out[os.path.basename(path)] = [r.get(i) for i in range(len(r))]
    return out


@pytest.mark.parametrize("version", [1, 2])
def test_generate_corpus_matches_jax(tmp_path, version):
    kw = dict(n_train=4, n_dev=2, n_test=2, seed=0, train_split=2, version=version)
    got = toy.generate_corpus(str(tmp_path / "port"), get_config("ljspeech"), **kw)
    want = jax_toy.generate_corpus(str(tmp_path / "jax"), jax_get_config("ljspeech"), **kw)
    assert got == want
    port, ref = _shards(str(tmp_path / "port")), _shards(str(tmp_path / "jax"))
    assert sorted(port) == sorted(ref) == ["dev-0.vrs", "test-0.vrs", "train-0.vrs",
                                           "train-1.vrs"]
    for name in port:
        assert [(u.fid, u.text.tolist()) for u in port[name]] == \
            [(u.fid, u.text.tolist()) for u in ref[name]]
        for a, b in zip(port[name], ref[name]):
            np.testing.assert_allclose(a.mel, b.mel, atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def decoders():
    """The port's and the JAX package's decoders, on a declination grid cut
    from 0-5 to 0-2 semitones (9 of 21 template rows a letter) for time."""
    return toy.ToyLetterDecoder(get_config("ljspeech"), decl_max=2.0), \
        jax_toy.ToyLetterDecoder(jax_get_config("ljspeech"), decl_max=2.0)


def test_letter_decoder_templates_match_jax(decoders):
    port, ref = decoders
    np.testing.assert_array_equal(port.shifts, ref.shifts)
    np.testing.assert_allclose(port.letter_templates, ref.letter_templates, atol=ATOL, rtol=0)
    np.testing.assert_allclose(port.sil_template, ref.sil_template, atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [1, 2])
def test_letter_decoder_transcribes_as_jax(decoders, seed):
    port, ref = decoders
    hp = jax_get_config("ljspeech")
    rng = np.random.default_rng(seed)
    text = jax_toy.random_text(rng)
    mel = JaxAudioProcessor(hp.audio).melspectrogram(
        jax_toy.synthesize_utterance_v2(text, hp, rng)).T
    np.testing.assert_array_equal(port.frame_symbols(mel), ref.frame_symbols(mel))
    hyp = port.decode(mel)
    assert hyp == ref.decode(mel)
    # the renders are decoded almost letter for letter
    assert toy.letter_error_rate(hyp, text) < 0.5


@pytest.mark.parametrize("hyp,ref", [
    ("", ""), ("a", ""), ("", "abc"), ("abc", "abc"), ("abd", "abc"), ("ab", "abc"),
    ("abcd", "abc"), ("xyz", "abc"), ("ab c", "abc"), ("kitten", "sitting"),
])
def test_letter_error_rate_matches_jax(hyp, ref):
    assert toy.letter_error_rate(hyp, ref) == jax_toy.letter_error_rate(hyp, ref)


def test_letter_error_rate_values():
    assert toy.letter_error_rate("", "") == 0.0
    assert toy.letter_error_rate("a", "") == 1.0
    assert toy.letter_error_rate("kitten", "sitting") == pytest.approx(3 / 7)


@pytest.mark.parametrize("seed", [0, 4242, 9191])
def test_random_text_matches_jax(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(8):
        text = toy.random_text(a)
        assert text == jax_toy.random_text(b)
        assert set(text) <= set(toy.LETTERS + " ")
        assert all(2 <= len(w) <= 6 for w in text.split())


def test_v1_utterance_matches_jax():
    np.testing.assert_array_equal(
        toy.synthesize_utterance("ab c", get_config("ljspeech")),
        jax_toy.synthesize_utterance("ab c", jax_get_config("ljspeech")))
