"""The neural vocoder's card-against-CPU gate (``chip_smoke.py``'s
``vocoder_card_cpu_shares``), on the CPU with a head output made up from a
seed at a small audio config (n_fft 256, hop 64):

* two head outputs that differ by 1e-6 of their largest element, as the
  card's and the CPU's do, with one bin whose (re, im) is near 0: the old
  measure, the frames against each other within TOL_VOC_CARD_CPU, fails on
  them, and the gate (the head itself, the frame math and the iSTFT from
  one head) holds;
* a 1e-3 change of the head fails the gate;
* ``MelVocoder.forward`` is ``head_to_frames`` of ``head_output``.
"""

import numpy as np
import torch

import chip_smoke
from vaenar_tts_torch.configs.hparams import AudioConfig
from vaenar_tts_torch.models.vocoder import MelVocoder, VocoderConfig, head_to_frames

from torch_threads import one_thread  # noqa: F401

AUDIO = AudioConfig(num_freq=129, frame_length_sample=256, frame_shift_sample=64)
BINS, FRAMES, CLIP = 129, 12, VocoderConfig.log_magnitude_clip
NEAR_ZERO = (5, 40)  # (frame, bin) whose (re, im) is near 0


def head(seed=0):
    """[1, FRAMES, 3 * BINS]: log magnitudes in [-3, 2], (re, im) ~ N(0, 1),
    and at NEAR_ZERO a loud bin (log magnitude 2) pointing nowhere."""
    rng = np.random.default_rng(seed)
    h = np.concatenate([rng.uniform(-3.0, 2.0, (1, FRAMES, BINS)),
                        rng.standard_normal((1, FRAMES, 2 * BINS))], axis=-1)
    t, b = NEAR_ZERO
    h[0, t, b], h[0, t, BINS + b], h[0, t, 2 * BINS + b] = 2.0, 1e-5, -1e-5
    return torch.from_numpy(h.astype(np.float32))


def moved(h, share, seed=1):
    noise = np.random.default_rng(seed).uniform(-1.0, 1.0, h.shape).astype(np.float32)
    return h + share * h.abs().max() * torch.from_numpy(noise)


def shares(h_card, h_cpu):
    return chip_smoke.vocoder_card_cpu_shares(torch, h_card, h_cpu, CLIP, AUDIO, "cpu")


def test_gate_holds_where_the_frames_turn():
    h = head()
    gated, printed = shares(moved(h, 1e-6), h)
    assert printed["frames"] > chip_smoke.TOL_VOC_CARD_CPU  # the old gate fails
    assert max(gated.values()) <= chip_smoke.TOL_VOC_CARD_CPU
    assert gated["frames_math"] == 0.0 and gated["istft_math"] == 0.0  # one device here


def test_gate_fails_on_a_changed_head():
    h = head()
    gated, _ = shares(moved(h, 1e-3), h)
    assert gated["head"] > chip_smoke.TOL_VOC_CARD_CPU


def test_forward_is_the_frames_of_the_head():
    torch.manual_seed(0)
    model = MelVocoder(VocoderConfig(hidden=16, n_blocks=1), AUDIO).eval()
    mel = torch.rand(2, FRAMES, AUDIO.num_mels)
    with torch.no_grad():
        want = model(mel)
        got = head_to_frames(model.head_output(mel), model.cfg.log_magnitude_clip)
    assert got.shape == (2, 2 * BINS, FRAMES) and torch.equal(got, want)
