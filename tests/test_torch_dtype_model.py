"""The port's model at compute dtype bfloat16: the dev step against the JAX
package's at bfloat16, where each precision lives, and the config field and
CLI flag that choose it.

The dev step runs the tiny model and batch of test_torch_train_step.py
(Pallas attention in interpret mode on the JAX side, dropout off, the
posterior noise injected on both sides) with ``train.compute_dtype``
overridden to bfloat16 on both sides. Each module alone gives JAX's bf16
output bit for bit at small shapes (test_torch_dtype_modules.py), but at the
batch's lengths (attention over up to 120 reduced frames) fp32 sums taken
in another order put some elements on the other side of a bf16 rounding
edge, one bf16 ulp (2^-8 relative) apart, and the layers after carry that
on. Measured on this CPU: mel_l2 within 5.3e-4 relative, len_l2 2.5e-4, the
pinball term 7.1e-7, the total 4.8e-5 (at fp32 the same step agrees to
3.1e-7). Bounds: 5e-3 relative for those; the kl, a difference of two large
fp32 log-prob sums (1181 here), is held absolutely, as the JAX package's
own bf16 test holds it (tests/test_round2_fixes.py): measured 0.055, bound
0.5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaenar_tts_tpu.configs import apply_overrides as jax_overrides
from vaenar_tts_tpu.models import vaenar as jvaenar
from vaenar_tts_tpu.training.steps import make_dev_step
from vaenar_tts_torch.cli import inference
from vaenar_tts_torch.configs.hparams import TrainConfig
from vaenar_tts_torch.configs.overrides import apply_overrides
from vaenar_tts_torch.configs.serialize import load_hparams, save_hparams
from vaenar_tts_torch.interop.weights import torch_to_jax
from vaenar_tts_torch.models import flow as tflow
from vaenar_tts_torch.models.vaenar import load_model
from vaenar_tts_torch.ops.flash_attention import MaskedFlashAttention
from vaenar_tts_torch.training import steps
from vaenar_tts_torch.utils.export import EXPORT_NAME, save_npz

from test_torch_model import SHIPPED
from test_torch_train_step import (B, KL_WEIGHT, MEL, R, batch, hparams_from_dict,
                                   hparams_to_dict, inject, port_model,
                                   random_variables, tiny_hparams)
from torch_threads import one_thread  # noqa: F401

BF16 = ["train.compute_dtype=bfloat16"]
LOSS_RTOL = 5e-3
KL_ATOL = 0.5
VALID = np.asarray([1.0, 1.0], np.float32)


@pytest.fixture(scope="module")
def bf16_setup():
    hp = jax_overrides(tiny_hparams(), BF16)
    params, stats = random_variables(hp, seed=41)
    return hp, params, stats, batch(7)


def test_dev_step_matches_jax_at_bf16(bf16_setup):
    hp, params, stats, (texts, mels, t_lens, m_lens) = bf16_setup
    assert hp.train.compute_dtype == "bfloat16"
    eps = np.random.default_rng(9).standard_normal(
        (B, 1, MEL // R, hp.common.latent_dim)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        inject(mp, eps)
        want = make_dev_step(hp, jvaenar.VAENAR(hp))(
            params, stats, texts, mels, t_lens, m_lens, jnp.float32(KL_WEIGHT),
            jnp.asarray(VALID), jax.random.key(0), reduction_factor=R)
    model = port_model(hp, params, stats)
    assert model.text_encoder.compute_dtype == torch.bfloat16
    got = steps.dev_step(
        model, hparams_from_dict(hparams_to_dict(hp)), torch.from_numpy(texts).long(),
        torch.from_numpy(mels), torch.from_numpy(t_lens), torch.from_numpy(m_lens),
        KL_WEIGHT, torch.from_numpy(VALID), R, epsilon=torch.from_numpy(eps))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == torch.float32, key
        if key == "kl":
            assert abs(float(got[key]) - float(want[key])) <= KL_ATOL
        else:
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=LOSS_RTOL, err_msg=key)


def test_bf16_train_step_precisions(bf16_setup, monkeypatch):
    """One bf16 train step of the port: q, k and v reach MaskedFlashAttention
    in bf16 and o leaves it in bf16; every flow layer's output and logdet
    are fp32; the losses are fp32; every parameter and gradient stays
    fp32."""
    hp, params, stats, (texts, mels, t_lens, m_lens) = bf16_setup
    model = port_model(hp, params, stats)
    seen = {"attention": [], "flow": []}
    apply = MaskedFlashAttention.apply

    def spy(q, k, v, *rest):
        o = apply(q, k, v, *rest)
        seen["attention"].append((q.dtype, k.dtype, v.dtype, o.dtype))
        return o

    monkeypatch.setattr(MaskedFlashAttention, "apply", spy)
    for mod in model.modules():
        if isinstance(mod, (tflow.ActNorm, tflow.InvertibleLinear, tflow.TransformerCoupling)):
            mod.register_forward_hook(
                lambda m, a, out: seen["flow"].append((out[0].dtype, out[1].dtype)))
    optimizer = steps.make_optimizer(hparams_from_dict(hparams_to_dict(hp)), model)
    eps = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, 1, MEL // R, hp.common.latent_dim)).astype(np.float32))
    metrics = steps.train_step(
        model, optimizer, hparams_from_dict(hparams_to_dict(hp)),
        torch.from_numpy(texts).long(), torch.from_numpy(mels), torch.from_numpy(t_lens),
        torch.from_numpy(m_lens), KL_WEIGHT, R, epsilon=eps)
    # encoder 1, posterior 1 and decoder 1 blocks, 2 couplings of 1 block
    assert len(seen["attention"]) == 1 + 2 * (1 + 1 + 2)
    assert set(seen["attention"]) == {(torch.bfloat16,) * 4}
    assert len(seen["flow"]) == 3 * 2 and set(seen["flow"]) == {(torch.float32,) * 2}
    assert all(v.dtype == torch.float32 and torch.isfinite(v) for v in metrics.values())
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p).all(), name


def test_shipped_config_is_bf16_and_the_field_is_checked():
    assert load_hparams(SHIPPED).train.compute_dtype == "bfloat16"
    assert TrainConfig().compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype"):
        TrainConfig(compute_dtype="float16")
    hp = load_hparams(SHIPPED)
    with pytest.raises(ValueError, match="compute_dtype"):
        apply_overrides(hp, ["train.compute_dtype=fp32"])
    assert apply_overrides(hp, ["train.compute_dtype=float32"]).train.compute_dtype == "float32"


def test_cli_compute_dtype_overrides_the_model_dir(tmp_path, monkeypatch):
    """A bf16 model directory synthesizes at bf16, and at fp32 under
    ``--compute_dtype float32``; the mels are fp32 either way."""
    hp = apply_overrides(hparams_from_dict(hparams_to_dict(tiny_hparams())), BF16)
    params, stats = torch_to_jax(steps.init_model(hp, 0, "cpu"))
    model_dir = str(tmp_path / "ckpt")
    save_hparams(hp, model_dir)
    save_npz(os.path.join(model_dir, EXPORT_NAME),
             {"params": params, "batch_stats": stats, "epoch": 1})
    text = tmp_path / "lines.txt"
    text.write_text("Hello world.\n")
    loaded = []

    def spy(*args, **kwargs):
        out = load_model(*args, **kwargs)
        loaded.append(out[1].decoder.pre_projection.compute_dtype)
        return out

    monkeypatch.setattr(inference, "load_model", spy)
    base = ["--dataset", "ljspeech", "--text", str(text), "--model_dir", model_dir,
            "--device", "cpu", "--temperature", "0"]
    for run, extra in (("bf16", []), ("fp32", ["--compute_dtype", "float32"])):
        inference.main(base + ["--test_dir", str(tmp_path / run)] + extra)
        mel = np.load(tmp_path / run / "test-1-0.npy")
        assert mel.dtype == np.float32 and np.isfinite(mel).all()
    assert loaded == [torch.bfloat16, torch.float32]
