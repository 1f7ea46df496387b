"""Heads wider than 256 in the port: one head of 384 in every attention
stack of a tiny model, and the model's attention at one head of 384 and of
512, against the JAX package.

Every head width above 256 runs on the wide kernels at the next multiple
of 128 (csrc/masked_attention_wide_tc.cu, csrc/masked_attention_wide.cu:
their grids take the D / 128 output slices, and S is summed over panels of
64 columns; the fp32 forward on csrc/masked_attention_fwd_3xtf32.cu); here,
as on the CPU, through the plain version the wrapper
takes for CPU tensors (tests/test_torch_head_widths.py holds the padding
route to those widths, at D = 320). Here, as tests/test_torch_wide_heads.py
holds one head of 256:

* the port's ``MultiHeadAttention`` at one head of 384 and of 512 against
  the JAX module on its Pallas path (interpret mode on the CPU, as the JAX
  package's own tests run it), causal and not: the contexts to atol 2e-5,
  the gradients of the inputs and of the q, k, v kernels to atol 1e-4
  (fp32, sums taken in another order);
* a tiny VAENAR whose four attention stacks are each one head of 384 (and
  whose posterior takes inputs 384 wide, which its blocks need),
  written once in the JAX package's export format (``save_hparams``,
  ``save_npz``) and read by both packages (the port through ``load_model``,
  that is ``load_jax_weights``): synthesis at temperature 0 with the
  Pallas attention on, lengths equal and mels to atol 1e-4 (the tolerance
  of tests/test_torch_model.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaenar_tts_tpu.configs import apply_overrides, get_config
from vaenar_tts_tpu.configs.serialize import hparams_to_dict, save_hparams
from vaenar_tts_tpu.models import attention as jatt
from vaenar_tts_tpu.models.vaenar import VAENAR as JaxVAENAR
from vaenar_tts_tpu.training.steps import make_inference_step
from vaenar_tts_tpu.utils.export import load_npz, save_npz
from vaenar_tts_torch.cli import inference
from vaenar_tts_torch.configs.serialize import hparams_from_dict
from vaenar_tts_torch.interop.weights import load_jax_weights, torch_to_jax
from vaenar_tts_torch.models import attention as tatt
from vaenar_tts_torch.models.vaenar import VAENAR, load_model

from test_torch_head_widths import _randomize
from test_torch_model import LINES, MEL_ATOL, TINY_OVERRIDES, randomize, randomize_model
from torch_threads import one_thread  # noqa: F401

STACKS = ("encoder", "decoder", "posterior", "prior")
# the posterior's blocks add their attention's output to their input, so
# its input width follows (vaenar_tts_tpu/models/attention.py:246-247)
ONE_HEAD_OF_384 = ([f"{stack}.attention_dim=384" for stack in STACKS]
                   + [f"{stack}.attention_heads=1" for stack in STACKS]
                   + ["posterior.pre_hidden=384"])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dim", [384, 512])
def test_multi_head_attention_above_d256_matches_jax(dim, causal):
    """One head of 384 (three of the wide kernels' slices) and one of 512
    (four), the JAX module on its Pallas path: contexts, and the gradients
    of sum(out * g) for the inputs and the q, k, v kernels."""
    B, tq, tk = 2, 64, 64 if causal else 48
    rng = np.random.default_rng(dim + causal)
    x = rng.standard_normal((B, tq, 24)).astype(np.float32)
    mem = x if causal else rng.standard_normal((B, tk, 12)).astype(np.float32)
    ql = np.array([tq, 41], np.int32)
    ml = ql if causal else np.array([29, tk], np.int32)
    g = rng.standard_normal((B, tq, dim)).astype(np.float32)

    jm = jatt.MultiHeadAttention(dim, 1, temperature=1.3, use_pallas=True)
    tm = tatt.MultiHeadAttention(24, mem.shape[-1], dim, 1, temperature=1.3)
    assert tm.head_dim == dim
    params = _randomize(jm.init(jax.random.key(0), x, mem, ql, ml, causal=causal)["params"],
                        np.random.default_rng(dim + 2 + causal))
    load_jax_weights(tm, params, {})

    def loss(p, x_, mem_):
        out, _ = jm.apply({"params": p}, x_, mem_ if not causal else x_, ql, ml,
                          causal=causal)
        return jnp.sum(out * g), out

    (_, out_j), grads_j = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(mem))

    tx = torch.from_numpy(x).requires_grad_()
    tmem = tx if causal else torch.from_numpy(mem).requires_grad_()
    out_t = tm(tx, tmem, torch.from_numpy(ql), torch.from_numpy(ml), causal=causal)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=2e-5, rtol=0)
    (out_t * torch.from_numpy(g)).sum().backward()

    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(grads_j[1]), atol=1e-4, rtol=1e-4)
    if not causal:
        np.testing.assert_allclose(tmem.grad.numpy(), np.asarray(grads_j[2]), atol=1e-4,
                                   rtol=1e-4)
    for name in ("query_layer", "key_layer", "value_layer"):
        np.testing.assert_allclose(getattr(tm, name).weight.grad.numpy().T,
                                   np.asarray(grads_j[0][name]["kernel"]), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


@pytest.fixture(scope="module")
def one_head_export(tmp_path_factory):
    """(JAX hparams, the export's variables, the export's directory) of the
    tiny model with one head of 384 in every stack: the port's tree in flax
    form (``torch_to_jax``), randomized from a numpy seed, written with the
    JAX package's writer and read back, as tests/test_torch_inference_cli.py
    writes its tiny export."""
    out = str(tmp_path_factory.mktemp("one_head_export"))
    hp = apply_overrides(get_config("ljspeech"), TINY_OVERRIDES + ONE_HEAD_OF_384)
    params, stats = torch_to_jax(VAENAR(hparams_from_dict(hparams_to_dict(hp))))
    rng = np.random.default_rng(31)
    params, stats = randomize_model(params, rng), randomize(stats, rng)
    save_hparams(hp, out)
    save_npz(os.path.join(out, "export.npz"), {"params": params, "batch_stats": stats, "epoch": 1})
    state = load_npz(os.path.join(out, "export.npz"))  # float16 leaves: both sides read these
    return hp, {"params": state["params"], "batch_stats": state["batch_stats"]}, out


def test_one_head_of_384_model_loads_and_synthesizes_as_jax(one_head_export):
    hp, variables, model_dir = one_head_export
    _, port, _ = load_model(model_dir, "cpu")
    for stack in STACKS:
        assert getattr(port.hp, stack).attention_heads == 1
        assert getattr(port.hp, stack).attention_dim == 384
    # every leaf of the export carried over unchanged (fp16 in the file)
    params_back, stats_back = torch_to_jax(port)
    for want, got in ((variables["params"], params_back),
                      (variables["batch_stats"], stats_back)):
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path], np.float32),
                                          np.asarray(leaf, np.float32), err_msg=str(path))

    batch, text_lens, max_mel = inference.pad_lines(port.hp,
                                                    inference.encode_lines(port.hp, LINES))
    step = make_inference_step(hp, JaxVAENAR(hp))
    mels, lens = step(variables["params"], variables["batch_stats"],
                      jnp.asarray(batch, jnp.int32), jnp.asarray(text_lens), jax.random.key(0),
                      reduction_factor=2, max_mel_length=max_mel, temperature=0.0,
                      length_headroom=0, use_length_quantile=True)[:2]
    t_mels, t_lens = inference.synthesize(port, port.hp, batch, text_lens, max_mel, 0.0, True)
    assert t_lens.tolist() == np.asarray(lens).tolist()
    assert 0 < min(t_lens.tolist()) and max(t_lens.tolist()) < max_mel
    np.testing.assert_allclose(t_mels.numpy(), np.asarray(mels), atol=MEL_ATOL)
