"""Head widths in the port's attention wrapper: which native kernel width a
head width runs at, the zero padding that carries every other width there,
and the model's attention at D = 128 against the JAX package's
(tests/test_torch_wide_heads.py holds one head of 256,
tests/test_torch_widest_heads.py one of 384 and one of 512).

The kernels are compiled for D = 64, 128 and 256, and the wide kernels take
every multiple of 128 above 256; any other width is padded with zero
columns to the next native one and the results are sliced back, which is exact (a zero column adds nothing to a score, and the
columns it adds to o and the gradients are zero). Here the route is taken
as the wrapper takes it on a card, pad -> plain version -> slice, and held
against the plain version at the true width: fp32, atol 1e-6 (the same
products, with zero terms added). The port's ``MultiHeadAttention`` at
two heads of 128 is held against the JAX package's with the same weights,
its Pallas path in interpret mode as the JAX package's own tests run it,
to the tolerances tests/test_torch_attention.py and tests/test_torch_modules.py
hold at narrow widths: the contexts atol 2e-5, the gradients atol 1e-4
(fp32, sums taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401

from vaenar_tts_tpu.models import attention as jatt
from vaenar_tts_torch.interop.weights import load_jax_weights
from vaenar_tts_torch.models import attention as tatt
from vaenar_tts_torch.ops import flash_attention as fa

PADDED_WIDTHS = (8, 32, 96, 160, 192, 320)
ATOL_PAD = 1e-6


def test_kernel_width_of_every_width_up_to_128():
    """Every width up to 256, the widest compiled instantiation (the name is
    the test's from when the kernels stopped at 128); there is no upper
    width any more."""
    got = {d: fa.kernel_width(d) for d in range(1, 257)}
    assert got == {d: 64 if d <= 64 else 128 if d <= 128 else 256 for d in range(1, 257)}
    assert fa.KERNEL_HEAD_DIMS == (64, 128, 256) and not hasattr(fa, "MAX_HEAD_DIM")


@pytest.mark.parametrize("width,native", [(257, 384), (384, 384), (385, 512), (512, 512),
                                          (1000, 1024)])
def test_kernel_width_above_256_is_the_next_multiple_of_128(width, native):
    """Above 256 a width runs on the wide kernels at the next multiple of
    128, natively when it is one."""
    assert fa.kernel_width(width) == native
    assert fa.is_native_width(width) == (width == native)


@pytest.mark.parametrize("width", [0, -1])
def test_kernel_width_raises_outside_1_to_128(width):
    """Widths below 1 raise, and the message says what the kernels take
    (the name is the test's from when widths above the widest
    instantiation raised too)."""
    with pytest.raises(ValueError, match=r"head widths of 1 and more \(native \(64, 128, 256\) "
                                         r"and every multiple of 128 above"):
        fa.kernel_width(width)


@pytest.mark.parametrize("D", [8, 32, 96, 128, 160, 256, 272, 384])
def test_check_kernel_inputs_takes_widths_up_to_128(D):
    q, k, v = (torch.zeros(2, 2, t, D) for t in (5, 7, 7))
    fa._check_kernel_inputs(q, k, v, torch.zeros_like(q))


def test_check_kernel_inputs_raises_above_128():
    """A width the kernels do not take, 0 (no width is too wide any more;
    the name is the test's from when one was), is refused before any
    launch."""
    q, k, v = (torch.zeros(2, 2, t, 0) for t in (5, 7, 7))
    with pytest.raises(ValueError, match="got 0"):
        fa._check_kernel_inputs(q, k, v)


@pytest.mark.parametrize("D,suffix", [(8, ""), (32, ""), (64, ""), (96, "_d128"),
                                      (128, "_d128"), (129, "_d256"), (160, "_d256"),
                                      (256, "_d256"), (257, "_wide"), (320, "_wide"),
                                      (384, "_wide"), (512, "_wide"), (1024, "_wide")])
def test_kernel_names_follow_the_native_width(D, suffix):
    for kind, base in (("fwd", "masked_attention_fwd"), ("dq", "masked_attention_bwd_dq"),
                       ("dkv", "masked_attention_bwd_dkv")):
        for dtype, tc in ((torch.float32, ""), (torch.bfloat16, "_tc")):
            name = fa.kernel_name(kind, dtype, D)
            assert name == f"{base}{tc}{suffix}"
            assert fa.c_function(name) == f"{base}{tc}"  # one C function, every width
            assert (name in fa.DELTA_FORMING_KERNELS) == (kind == "dq")


@pytest.mark.parametrize("D,native", [(96, False), (320, False), (384, True)])
def test_launch_backward_kernel_takes_native_widths_only(D, native):
    """A width that is not native is refused before anything is loaded; a
    native one (384: the wide kernels) passes the width check and reaches
    the kernel name, whose launch needs a card (here the name check on the
    missing ``o`` of a dQ kernel stops it first)."""
    q = torch.zeros(1, 1, 4, D)
    stat = torch.zeros(1, 1, 4)
    if not native:
        with pytest.raises(ValueError, match="native widths"):
            fa.launch_backward_kernel("dkv", q, q, q, q, None, None, stat, stat, stat, (q, q),
                                      0.1, False)
        return
    with pytest.raises(ValueError, match=r"masked_attention_bwd_dq_wide reads o"):
        fa.launch_backward_kernel("dq", q, q, q, q, None, None, stat, stat, stat, (q,),
                                  0.1, False)


def _inputs(D, seed, tq=40, tk=33):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((2, 3, tq, D)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, 3, tk, D)).astype(np.float32))
            for _ in range(2))
    ql = torch.tensor([tq, 17], dtype=torch.int32)
    ml = torch.tensor([20, tk], dtype=torch.int32)
    return q, k, v, do, ql, ml


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", PADDED_WIDTHS)
def test_padding_route_forward_matches_plain(D, causal):
    q, k, v, _, ql, ml = _inputs(D, D)
    scale = D ** -0.5  # the true width's scale, passed through unchanged
    width = fa.kernel_width(D)
    padded = fa.pad_head_width(width, q, k, v)
    assert all(t.shape[-1] == width and t.is_contiguous() for t in padded)
    o_pad, m_pad, s_pad = fa.masked_attention_reference(*padded, ql, ml, scale, causal)
    o, m, s = fa.masked_attention_reference(q, k, v, ql, ml, scale, causal)
    assert torch.all(o_pad[..., D:] == 0)
    np.testing.assert_allclose(o_pad[..., :D].numpy(), o.numpy(), atol=ATOL_PAD, rtol=0)
    np.testing.assert_allclose(m_pad.numpy(), m.numpy(), atol=ATOL_PAD, rtol=0)
    np.testing.assert_allclose(s_pad.numpy(), s.numpy(), atol=ATOL_PAD, rtol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", PADDED_WIDTHS)
def test_padding_route_backward_matches_plain(D, causal):
    q, k, v, do, ql, ml = _inputs(D, 10 + D)
    scale = D ** -0.5
    o, m, s = fa.masked_attention_reference(q, k, v, ql, ml, scale, causal)
    width = fa.kernel_width(D)
    got = fa.masked_attention_backward_reference(
        *fa.pad_head_width(width, q, k, v), ql, ml, *fa.pad_head_width(width, o), m, s,
        *fa.pad_head_width(width, do), scale, causal)
    want = fa.masked_attention_backward_reference(q, k, v, ql, ml, o, m, s, do, scale, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.all(g[..., D:] == 0), name
        np.testing.assert_allclose(g[..., :D].numpy(), w.numpy(), atol=ATOL_PAD, rtol=0,
                                   err_msg=name)
    dq, delta = fa.masked_attention_dq_reference(
        *fa.pad_head_width(width, q, k, v, do, o), ql, ml, m, s, scale, causal)
    np.testing.assert_allclose(dq[..., :D].numpy(), want[0].numpy(), atol=ATOL_PAD, rtol=0)
    np.testing.assert_allclose(delta.numpy(),
                               fa.masked_attention_dq_reference(q, k, v, do, o, ql, ml, m, s,
                                                                scale, causal)[1].numpy(),
                               atol=ATOL_PAD, rtol=0)


def _randomize(tree, rng):
    return {key: (_randomize(value, rng) if hasattr(value, "items")
                  else (0.3 * rng.standard_normal(np.shape(value))).astype(np.float32))
            for key, value in tree.items()}


@pytest.mark.parametrize("causal", [True, False])
def test_multi_head_attention_at_d128_matches_jax(causal):
    """Two heads of 128 (attention_dim 256), the JAX module on its Pallas
    path (interpret mode on the CPU): contexts, and the gradients of
    sum(out * g) for the inputs and the q, k, v kernels."""
    B, tq, tk, dim = 2, 64, 64 if causal else 48, 256
    rng = np.random.default_rng(19)
    x = rng.standard_normal((B, tq, 24)).astype(np.float32)
    mem = x if causal else rng.standard_normal((B, tk, 12)).astype(np.float32)
    ql = np.array([tq, 41], np.int32)
    ml = ql if causal else np.array([29, tk], np.int32)
    g = rng.standard_normal((B, tq, dim)).astype(np.float32)

    jm = jatt.MultiHeadAttention(dim, 2, temperature=1.3, use_pallas=True)
    tm = tatt.MultiHeadAttention(24, mem.shape[-1], dim, 2, temperature=1.3)
    assert tm.head_dim == 128
    params = _randomize(jm.init(jax.random.key(0), x, mem, ql, ml, causal=causal)["params"],
                        np.random.default_rng(20))
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
