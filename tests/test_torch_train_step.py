"""One ELBO train step of the port against the JAX package's.

A tiny model (the override set of test_torch_model.py, dropout rates 0, a
0.9 quantile length head, Pallas attention in interpret mode) gets random
weights from a numpy seed on both sides. Both run ``train=True`` (BatchNorm
on batch statistics) on the same batch at r = 2, with the same posterior
noise: the JAX package's ``reparameterize`` is patched to return it. One
``jax.value_and_grad`` of the JAX train step's loss, then optax's Adam,
against one ``training.steps.train_step`` of the port:

* mel_l2, kl, len_l2 and the pinball term agree to 1e-5 relative;
* every gradient leaf, mapped through ``torch_to_jax``, agrees within
  1e-4 + 1e-3 * max|g_jax| of that leaf (fp32 sums in another order through
  ~20 layers and a reverse flow);
* the BatchNorm running statistics after the step agree to 1e-5, which
  ``nn.BatchNorm1d``'s unbiased update would miss;
* each parameter's Adam update agrees to 1e-3 * lr wherever |g_jax| is
  above 1e-5, and is 0 wherever g_jax is 0 (see the test); three steps of
  the optimizer alone agree with optax's on random gradients.

``grad_accum = 2`` is checked in the port alone: it equals the average of
the two micro-batches' gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vaenar_tts_tpu.configs import apply_overrides, get_config
from vaenar_tts_tpu.configs.serialize import hparams_to_dict
from vaenar_tts_tpu.models import vaenar as jvaenar
from vaenar_tts_tpu.training.steps import make_optimizer as jax_make_optimizer
from vaenar_tts_torch.configs.overrides import apply_overrides as port_overrides
from vaenar_tts_torch.configs.serialize import hparams_from_dict
from vaenar_tts_torch.interop.weights import flatten, load_jax_weights, torch_to_jax
from vaenar_tts_torch.models.vaenar import VAENAR
from vaenar_tts_torch.training import steps

from test_torch_model import TINY_OVERRIDES, randomize_model
from test_torch_modules import randomize
from torch_threads import one_thread  # noqa: F401

NO_DROPOUT = ["encoder.pre_drop_rate=0", "encoder.pos_drop_rate=0",
              "decoder.post_drop_rate=0", "posterior.pre_drop_rate=0",
              "posterior.pos_drop_rate=0"]
B, TEXT, MEL, R = 2, 32, 240, 2
KL_WEIGHT = 0.5
LOSS_RTOL = 1e-5


def tiny_hparams():
    return apply_overrides(get_config("ljspeech"), TINY_OVERRIDES + NO_DROPOUT)


def random_variables(hp, seed):
    """Random flax trees of the tiny model's shapes (no JAX init run)."""
    model = jvaenar.VAENAR(hp)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1),
         "sample": jax.random.key(2)},
        jnp.zeros((2, TEXT), jnp.int32), jnp.zeros((2, 120, 80)),
        jnp.full((2,), 120, jnp.int32), jnp.full((2,), TEXT, jnp.int32),
        reduction_factor=5, train=True))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    rng = np.random.default_rng(seed)
    return randomize_model(zeros["params"], rng), randomize(zeros["batch_stats"], rng)


def batch(seed=0):
    rng = np.random.default_rng(seed)
    texts = rng.integers(3, 43, (B, TEXT)).astype(np.int32)
    t_lens = np.asarray([TEXT, 19], np.int32)
    texts[1, 19:] = 0
    m_lens = np.asarray([MEL, 151], np.int32)
    mels = rng.uniform(0, 1, (B, MEL, 80)).astype(np.float32)
    mels[1, 151:] = 0
    return texts, mels, t_lens, m_lens


def port_model(hp, params, stats):
    model = VAENAR(hparams_from_dict(hparams_to_dict(hp)))
    load_jax_weights(model, params, stats)
    return model


def jax_loss_fn(model, hp, eps, reduction_factor, train):
    """The JAX train step's loss (``make_train_step``'s ``loss_fn``) with
    the posterior noise patched to ``eps``."""
    def loss_fn(p, bs, texts, mels, t_lens, m_lens):
        outs, updated = model.apply(
            {"params": p, "batch_stats": bs}, texts, mels, m_lens, t_lens,
            reduction_factor=reduction_factor, train=train, reduce_loss=True,
            rngs={"dropout": jax.random.key(0), "sample": jax.random.key(1)},
            mutable=["batch_stats", "diagnostics"])
        _, mel_l2, kl, len_l2, _ = outs
        pinball = updated["diagnostics"]["pinball"][-1]
        loss = mel_l2 + KL_WEIGHT * jnp.maximum(kl, 0.0) + hp.train.length_weight * len_l2
        return loss, (mel_l2, kl, len_l2 - pinball, pinball, updated["batch_stats"])
    return loss_fn


def inject(monkeypatch, eps):
    def fixed(rng, mu, logvar, nsamples=1, random=True):
        e = jnp.asarray(eps, mu.dtype)
        return e * jnp.exp(0.5 * logvar)[:, None] + mu[:, None], e
    monkeypatch.setattr(jvaenar, "reparameterize", fixed)


@pytest.fixture(scope="module")
def step():
    hp = tiny_hparams()
    params, stats = random_variables(hp, seed=21)
    texts, mels, t_lens, m_lens = batch()
    eps = np.random.default_rng(4).standard_normal(
        (B, 1, MEL // R, hp.common.latent_dim)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        inject(mp, eps)
        loss_fn = jax_loss_fn(jvaenar.VAENAR(hp), hp, eps, R, train=True)
        (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, stats, texts, mels, t_lens, m_lens)
    opt = jax_make_optimizer(hp)
    updates, _ = opt.update(grads, opt.init(params), params)
    jax_out = {"loss": loss, "aux": aux, "grads": grads, "params_before": params,
               "updates": updates}

    model = port_model(hp, params, stats)
    port_hp = hparams_from_dict(hparams_to_dict(hp))
    optimizer = steps.make_optimizer(port_hp, model)
    metrics = steps.train_step(
        model, optimizer, port_hp, torch.from_numpy(texts).long(),
        torch.from_numpy(mels), torch.from_numpy(t_lens), torch.from_numpy(m_lens),
        KL_WEIGHT, R, epsilon=torch.from_numpy(eps))
    return hp, jax_out, model, metrics


def test_losses_match_jax(step):
    _, jax_out, _, metrics = step
    mel_l2, kl, len_l2, pinball, _ = jax_out["aux"]
    for name, want in [("mel_l2", mel_l2), ("kl", kl), ("len_l2", len_l2),
                       ("len_pinball", pinball), ("total", jax_out["loss"])]:
        np.testing.assert_allclose(float(metrics[name]), float(want),
                                   rtol=LOSS_RTOL, err_msg=name)


def test_gradients_match_jax(step):
    _, jax_out, model, _ = step
    grads = {name: p.grad for name, p in model.named_parameters()}
    port, _ = torch_to_jax(model, grads)
    want, got = flatten(jax_out["grads"]), flatten(port)
    assert set(want) == set(got)
    n_nonzero = 0
    for key in want:
        g = np.asarray(want[key])
        tol = 1e-4 + 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(got[key], g, atol=tol, rtol=0, err_msg=key)
        n_nonzero += bool(np.abs(g).max() > 0)
    assert n_nonzero > 0.9 * len(want)


def test_batch_stats_after_the_step_match_jax(step):
    _, jax_out, model, _ = step
    _, stats = torch_to_jax(model)
    want, got = flatten(jax_out["aux"][4]), flatten(stats)
    assert set(want) == set(got) and len(want) > 0
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def _adam_tolerance(lr, after):
    """1e-3 * lr for the two frameworks' Adam arithmetic, plus half an fp32
    spacing of the parameter for the rounding of ``before + update``."""
    return 1e-3 * lr + 0.5 * np.spacing(np.abs(np.asarray(after, np.float32)))


def test_adam_step_matches_jax(step):
    """Each parameter's update (after minus before) against optax's. Adam's
    first step moves a parameter by lr * g / (|g| + eps): where |g_jax| is
    well above eps = 1e-7 (above 1e-5) that is a full +-lr step on both
    sides and must agree to 1e-3 * lr; where g_jax is exactly 0 the port's
    gradient is 0 too and the parameter stays. Only the elements between,
    whose update follows g / eps and so the last digits of g, are left out."""
    hp, jax_out, model, _ = step
    lr = hp.train.learning_rate
    params, _ = torch_to_jax(model)
    grads, _ = torch_to_jax(model, {n: p.grad for n, p in model.named_parameters()})
    got, before = flatten(params), flatten(jax_out["params_before"])
    want, g_jax, g_port = flatten(jax_out["updates"]), flatten(jax_out["grads"]), flatten(grads)
    n_left_out = n_total = 0
    for key in want:
        g = np.abs(np.asarray(g_jax[key]))
        update = np.asarray(got[key], np.float64) - np.asarray(before[key], np.float64)
        big, zero = g > 1e-5, g == 0
        err = np.abs(update - np.asarray(want[key], np.float64))
        assert np.all(err[big] <= _adam_tolerance(lr, got[key])[big]), \
            f"{key}: update error {err[big].max() / lr} lr"
        assert np.all(np.abs(update[big]) >= 0.9 * lr), f"{key}: a parameter did not move"
        assert np.all(g_port[key][zero] == 0) and np.all(update[zero] == 0), key
        n_left_out += int((~big & ~zero).sum())
        n_total += g.size
    assert n_left_out < 0.1 * n_total, f"{n_left_out} of {n_total} elements left out"


def test_optimizer_matches_optax_over_three_steps():
    """make_optimizer against the JAX package's optax.adam over three steps
    of random gradients from 1e-8 to 1 in size, so that b1, b2 and eps all
    act (bias correction cancels b1 and b2 on the first step)."""
    hp = tiny_hparams()
    rng = np.random.default_rng(8)
    shapes = {"a": (64,), "b": (8, 16)}
    params = {k: rng.uniform(-1, 1, s).astype(np.float32) for k, s in shapes.items()}
    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()})
    port_opt = steps.make_optimizer(hparams_from_dict(hparams_to_dict(hp)), module)
    jax_opt = jax_make_optimizer(hp)
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    state = jax_opt.init(jax_params)
    lr = hp.train.learning_rate
    for _ in range(3):
        grads = {k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-8, 0, s)).astype(np.float32)
                 for k, s in shapes.items()}
        before = {k: p.detach().numpy().astype(np.float64) for k, p in module.items()}
        for k, p in module.items():
            p.grad = torch.from_numpy(grads[k])
        port_opt.step()
        updates, state = jax_opt.update({k: jnp.asarray(g) for k, g in grads.items()},
                                        state, jax_params)
        for k, p in module.items():
            after = p.detach().numpy()
            err = np.abs(after - before[k] - np.asarray(updates[k], np.float64))
            assert np.all(err <= _adam_tolerance(lr, after)), f"{k}: {err.max() / lr} lr"


def test_grad_accum_averages_micro_batch_gradients():
    hp = port_overrides(hparams_from_dict(hparams_to_dict(tiny_hparams())),
                        ["prior.n_blk=1"])
    model = steps.init_model(hp, 3, "cpu")
    for head in ("mu_projection", "logvar_projection"):  # non-zero posterior heads
        torch.nn.init.normal_(getattr(model.posterior, head).weight, 0.0, 0.1)
    texts, mels, t_lens, m_lens = (torch.from_numpy(x) for x in batch(1))
    texts = texts.long()
    eps = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, 1, MEL // R, hp.common.latent_dim)).astype(np.float32))
    state = {k: v.clone() for k, v in model.state_dict().items()}

    def grads_of(accum, rows):
        model.load_state_dict(state)
        h = port_overrides(hp, [f"train.grad_accum={accum}"])
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        steps.train_step(model, opt, h, texts[rows], mels[rows], t_lens[rows],
                         m_lens[rows], KL_WEIGHT, R, epsilon=eps[rows])
        return {n: p.grad.clone() for n, p in model.named_parameters()}, \
            {n: b.clone() for n, b in model.named_buffers()}

    accum, stats = grads_of(2, slice(0, 2))
    first, _ = grads_of(1, slice(0, 1))
    model.load_state_dict(state)
    second, _ = grads_of(1, slice(1, 2))
    for name, g in accum.items():
        torch.testing.assert_close(g, (first[name] + second[name]) / 2,
                                   atol=1e-6, rtol=1e-4, msg=name)
    # BatchNorm statistics carried from the first micro-batch to the second
    bn = "text_encoder.EncoderPrenet.PreNetConv0.batch_norm.num_batches_tracked"
    assert int(stats[bn]) == 2
