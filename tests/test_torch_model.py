"""The port's VAENAR synthesis against the JAX package's, end to end.

A tiny model (the override set of the repo's verify recipe, plus a 0.9
quantile length head) is initialised in JAX, its variables are randomised
from a numpy seed and carried into the port by ``load_jax_weights``. JAX runs
with ``use_pallas_attention=on``, so its attention goes through the Pallas
kernel in interpret mode where the shapes allow it, as in
tests/test_flash_attention.py. Synthesis is compared at temperature 0, where
the prior noise is zero on both sides, and the flow stack with the same numpy
noise on both sides. Predicted lengths must be equal; mels agree to atol
1e-4 (fp32 through ~20 matmul layers, 2 flow steps and a conv stack, each
summing in another order than XLA; values are of order 1).

The full-size check on the shipped export is marked ``slow``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaenar_tts_tpu.configs import apply_overrides, get_config
from vaenar_tts_tpu.configs.serialize import hparams_to_dict
from vaenar_tts_tpu.models.vaenar import VAENAR as JaxVAENAR
from vaenar_tts_tpu.text.tokenizer import CharTokenizer as JaxTokenizer
from vaenar_tts_tpu.training.steps import init_model
from vaenar_tts_tpu.utils.export import load_npz as jax_load_npz
from vaenar_tts_torch.cli.inference import encode_lines, pad_to_multiple
from vaenar_tts_torch.configs.serialize import hparams_from_dict
from vaenar_tts_torch.models.vaenar import build_model

from test_torch_modules import randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "artifacts", "toyv2_q90", "ckpt")
MEL_ATOL = 1e-4

TINY_OVERRIDES = [
    "encoder.embd_dim=32", "encoder.pre_hidden=32", "encoder.n_conv=1",
    "encoder.n_blk=1", "encoder.attention_dim=16", "encoder.attention_heads=2",
    "encoder.ffn_hidden=32", "decoder.nblk=1", "decoder.attention_dim=16",
    "decoder.attention_heads=2", "decoder.ffn_hidden=32",
    "decoder.post_n_conv=1", "decoder.post_conv_filters=16",
    "posterior.pre_hidden=16", "posterior.nblk=1",
    "posterior.attention_dim=16", "posterior.attention_heads=2",
    "posterior.ffn_hidden=32", "prior.n_blk=1", "prior.n_transformer_blk=1",
    "prior.attention_dim=16", "prior.attention_heads=2",
    "prior.ffn_hidden=32", "common.latent_dim=8",
    "train.train_batch_size=8", "train.test_batch_size=4",
    "train.compute_dtype=float32",
    # beyond the verify recipe: the shipped model's quantile head, two flow
    # steps (both coupling orders) and the Pallas attention path
    "length_predictor.quantile=0.9", "prior.n_blk=2",
    "train.use_pallas_attention=on",
]
LINES = ["The quick brown fox jumps over the lazy dog.",
         "Dr. Smith paid $3.50 on the 2nd of May, 1906."]


def randomize_model(tree, rng):
    """``randomize`` of test_torch_modules, with length heads that predict
    ~3 frames a token so that lengths stay inside the bucket and the masks
    matter."""
    out = randomize(tree, rng)
    head_parent = out.get("length_predictor", {})
    for head in ("projection", "q_projection"):
        if head in head_parent:
            head_parent[head]["kernel"] *= 0.1
            head_parent[head]["bias"][:] = 1.2
    return out


@pytest.fixture(scope="module")
def tiny():
    hp = apply_overrides(get_config("ljspeech"), TINY_OVERRIDES)
    model = JaxVAENAR(hp)
    params, stats = init_model(hp, model, 0, text_max=32, mel_max=120)
    rng = np.random.default_rng(7)
    params, stats = randomize_model(params, rng), randomize(stats, rng)
    port = build_model(hparams_from_dict(hparams_to_dict(hp)), params, stats,
                       device="cpu")
    return hp, model, {"params": params, "batch_stats": stats}, port


def _batch(hp, lines):
    ids = encode_lines(hparams_from_dict(hparams_to_dict(hp)), lines)
    text_max = pad_to_multiple(max(map(len, ids)), hp.dataset.text_bucket)
    batch = np.zeros((len(ids), text_max), np.int32)
    for i, t in enumerate(ids):
        batch[i, :len(t)] = t
    return batch, np.asarray([len(t) for t in ids], np.int32)


def test_tokenizer_matches_jax():
    hp = get_config("ljspeech")
    lines = LINES + ["Mrs. Ørsted’s co-op—“naïve” 1,234th café… £20!"]
    jax_tok = JaxTokenizer(hp.text)
    port_ids = encode_lines(hparams_from_dict(hparams_to_dict(hp)), lines)
    assert port_ids == [jax_tok.encode_english(line) for line in lines]


@pytest.mark.parametrize("use_q", [True, False])
def test_infer_with_length_prediction_matches_jax(tiny, use_q):
    hp, model, variables, port = tiny
    batch, text_lens = _batch(hp, LINES)
    max_mel = 360
    mel, lens, _ = model.apply(
        variables, jnp.asarray(batch), jnp.asarray(text_lens),
        max_mel_length=max_mel, reduction_factor=2, temperature=0.0,
        length_headroom=0, use_length_quantile=use_q,
        method=JaxVAENAR.infer_with_length_prediction,
        rngs={"sample": jax.random.key(0)})
    t_mel, t_lens = port.infer_with_length_prediction(
        torch.from_numpy(batch).long(), torch.from_numpy(text_lens),
        max_mel_length=max_mel, reduction_factor=2, temperature=0.0,
        length_headroom=0, use_length_quantile=use_q)
    assert t_lens.tolist() == np.asarray(lens).tolist()
    assert 0 < min(t_lens.tolist()) and max(t_lens.tolist()) < max_mel
    np.testing.assert_allclose(t_mel.numpy(), np.asarray(mel), atol=MEL_ATOL)


def test_predict_lengths_and_infer_match_jax(tiny):
    hp, model, variables, port = tiny
    batch, text_lens = _batch(hp, LINES)
    mean, q = model.apply(variables, jnp.asarray(batch), jnp.asarray(text_lens),
                          method=JaxVAENAR.predict_lengths)
    t_mean, t_q = port.predict_lengths(torch.from_numpy(batch).long(),
                                       torch.from_numpy(text_lens))
    np.testing.assert_allclose(t_mean.numpy(), np.asarray(mean), rtol=1e-5)
    np.testing.assert_allclose(t_q.numpy(), np.asarray(q), rtol=1e-5)

    mel_lens = np.asarray([100, 57], np.int32)
    mel = model.apply(variables, jnp.asarray(batch), jnp.asarray(mel_lens),
                      jnp.asarray(text_lens), max_mel_length=120,
                      temperature=0.0, method=JaxVAENAR.infer,
                      rngs={"sample": jax.random.key(0)})[0]
    t_mel = port.infer(torch.from_numpy(batch).long(), torch.from_numpy(mel_lens),
                       torch.from_numpy(text_lens), max_mel_length=120,
                       temperature=0.0)
    np.testing.assert_allclose(t_mel.numpy(), np.asarray(mel), atol=MEL_ATOL)


def test_prior_forward_stack_with_injected_noise(tiny):
    hp, model, variables, port = tiny
    rng = np.random.default_rng(3)
    z_len, t_len = 40, 12
    eps = rng.standard_normal((2, z_len, hp.common.latent_dim)).astype(np.float32)
    cond = rng.standard_normal((2, t_len, hp.encoder.pre_hidden)).astype(np.float32)
    zl = np.asarray([z_len, 23], np.int32)
    cl = np.asarray([t_len, 7], np.int32)
    logp0 = np.zeros((2,), np.float32)
    z, logp = model.apply(
        variables, jnp.asarray(eps), jnp.asarray(logp0), jnp.asarray(cond),
        jnp.asarray(zl), jnp.asarray(cl),
        method=lambda m, *a: m.prior._forward_stack(*a))
    with torch.no_grad():
        t_z, t_logp = port.prior._forward_stack(
            torch.from_numpy(eps), torch.from_numpy(logp0),
            torch.from_numpy(cond), torch.from_numpy(zl), torch.from_numpy(cl))
    np.testing.assert_allclose(t_z.numpy(), np.asarray(z), atol=1e-4)
    np.testing.assert_allclose(t_logp.numpy(), np.asarray(logp), rtol=1e-5,
                               atol=1e-3)

    # the injected draw is the standard normal that temperature scales
    eps_t, logp_t = port.prior._initial_sample(torch.from_numpy(zl), z_len,
                                               temperature=0.5,
                                               epsilon=torch.from_numpy(eps))
    np.testing.assert_allclose(eps_t.numpy(), 0.5 * eps)
    assert torch.isfinite(logp_t).all()


@pytest.mark.slow
def test_shipped_export_matches_jax():
    """The shipped LJSpeech model at full width, in fp32 on both sides (the
    export's hparams say bfloat16, which the JAX package uses on the TPU)."""
    import dataclasses
    from vaenar_tts_tpu.configs.serialize import load_hparams
    from vaenar_tts_torch.models.vaenar import load_model

    hp = load_hparams(SHIPPED)
    hp = hp.replace(train=dataclasses.replace(hp.train, compute_dtype="float32"))
    state = jax_load_npz(os.path.join(SHIPPED, "export.npz"))
    variables = {"params": state["params"], "batch_stats": state["batch_stats"]}
    _, port, _ = load_model(SHIPPED, device="cpu")
    batch, text_lens = _batch(hp, ["Printing, in the only sense with which we "
                                   "are at present concerned."])
    max_mel = pad_to_multiple(int(batch.shape[1] * hp.common.mel_text_len_ratio * 2)
                              + 160, hp.dataset.mel_bucket)
    mel, lens, _ = JaxVAENAR(hp).apply(
        variables, jnp.asarray(batch), jnp.asarray(text_lens),
        max_mel_length=max_mel, temperature=0.0, length_headroom=0,
        use_length_quantile=True, method=JaxVAENAR.infer_with_length_prediction,
        rngs={"sample": jax.random.key(0)})
    t_mel, t_lens = port.infer_with_length_prediction(
        torch.from_numpy(batch).long(), torch.from_numpy(text_lens),
        max_mel_length=max_mel, temperature=0.0, length_headroom=0,
        use_length_quantile=True)
    assert t_lens.tolist() == np.asarray(lens).tolist()
    np.testing.assert_allclose(t_mel.numpy(), np.asarray(mel), atol=MEL_ATOL)
