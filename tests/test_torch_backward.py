"""The port's masked-attention backward against the JAX package's.

``masked_attention_backward_reference`` (the plain version of the two CUDA
backward kernels, which ``MaskedFlashAttention`` takes on CPU tensors) is held
against the JAX package's ``_pallas_backward`` (interpret mode on the CPU) at
the same (o, m, s, dO), and against ``jax.grad`` of ``masked_flash_attention``
for the causal, cross, fully-masked-row, empty-memory and ragged cases of
tests/test_flash_attention.py, at atol 5e-4 as there. ``gradcheck`` holds
the autograd Function against finite differences in float64. The kernels
themselves run only on a CUDA card: ``test_backward_kernels_match_plain_on_card``,
which also asserts which kernels launched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaenar_tts_tpu.ops import flash_attention as jax_fa
from vaenar_tts_torch.ops import flash_attention as fa

from test_torch_attention import B, CASES, D, _inputs, _jax, _torch
from torch_threads import one_thread  # noqa: F401

GRAD_ATOL = 5e-4


def _port_grads(q, k, v, ql, ml, scale, causal, g):
    """dq, dk, dv of sum(o * g) through the port's autograd Function."""
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.MaskedFlashAttention.apply(tq, tk, tv, _torch(ql), _torch(ml), scale, causal)
    (o * torch.from_numpy(g)).sum().backward()
    return [t.grad.numpy() for t in (tq, tk, tv)]


def _jax_grads(q, k, v, ql, ml, scale, causal, g):
    def loss(q_, k_, v_):
        return jnp.sum(jax_fa.masked_flash_attention(
            q_, k_, v_, _jax(ql), _jax(ml), scale, causal) * g)
    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(
        _jax(q), _jax(k), _jax(v))]


GRAD_CASES = dict(CASES, ragged_tq=dict(tq=60, tk=48, causal=False),
                  ragged_tk=dict(tq=64, tk=60, causal=False))


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_gradients_match_jax_grad(name):
    case = dict(GRAD_CASES[name])
    causal = case.pop("causal")
    q, k, v, ql, ml = _inputs(seed=len(name) + 40, **case)
    g = np.random.default_rng(3).standard_normal((B, 4, case["tq"], D)).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    port = _port_grads(q, k, v, ql, ml, scale, causal, g)
    ref = _jax_grads(q, k, v, ql, ml, scale, causal, g)
    for name_g, a, b in zip("qkv", port, ref):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, err_msg=f"d{name_g}")


@pytest.mark.parametrize("name", ["causal", "cross", "fully_masked_rows", "empty_memory"])
def test_plain_backward_matches_pallas_backward(name):
    """The same (o, m, s, dO) into both backwards: the JAX package's two
    Pallas kernels (interpret mode) and the port's plain version."""
    case = dict(CASES[name])
    causal = case.pop("causal")
    q, k, v, ql, ml = _inputs(seed=len(name) + 70, **case)
    tq, tk = case["tq"], case["tk"]
    g = np.random.default_rng(5).standard_normal((B, 4, tq, D)).astype(np.float32)
    scale = 0.3
    jql, jml = jax_fa._default_lengths(_jax(ql), _jax(ml), B, tq, tk)
    o, m, s = jax_fa._pallas_forward(_jax(q), _jax(k), _jax(v), jql, jml, scale,
                                     causal, with_stats=True)
    ref = jax_fa._pallas_backward(_jax(q), _jax(k), _jax(v), jql, jml, o, m, s,
                                  jnp.asarray(g), scale, causal)
    port = fa.masked_attention_backward_reference(
        _torch(q), _torch(k), _torch(v), _torch(ql), _torch(ml),
        torch.from_numpy(np.array(o)), torch.from_numpy(np.array(m)[..., 0]),
        torch.from_numpy(np.array(s)[..., 0]), torch.from_numpy(g), scale, causal)
    for name_g, a, b in zip("qkv", port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   err_msg=f"d{name_g}")


def test_masked_rows_reach_every_dv_row_and_no_dk():
    """Rows past q_len are uniform over ALL Tk keys, keys past m_len too: dV
    of every key gains their dO / Tk, while their dQ is 0 and they add
    nothing to dK. An item with m_len = 0 is uniform in every row: dK = 0."""
    q, k, v, _, _ = _inputs(16, 12, seed=9)
    ql, ml = np.asarray([5, 16], np.int32), np.asarray([7, 0], np.int32)
    g = np.random.default_rng(8).standard_normal((B, 4, 16, D)).astype(np.float32)
    dq, dk, dv = _port_grads(q, k, v, ql, ml, 0.25, False, g)
    np.testing.assert_array_equal(dq[0, :, 5:], 0.0)
    np.testing.assert_array_equal(dq[1], 0.0)
    np.testing.assert_array_equal(dk[1], 0.0)
    np.testing.assert_array_equal(dk[0, :, 7:], 0.0)
    # keys past m_len see only the masked rows: dV = sum of their dO / Tk
    np.testing.assert_allclose(dv[0, :, 7:], np.broadcast_to(
        g[0, :, 5:].sum(axis=1)[:, None] / 12, (4, 5, D)), atol=1e-6)
    np.testing.assert_allclose(dv[1], np.broadcast_to(
        g[1].sum(axis=1)[:, None] / 12, (4, 12, D)), atol=1e-6)


def test_gradcheck_float64():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, t, 8))).requires_grad_()
               for t in (7, 5, 5))
    ql, ml = torch.tensor([4, 7]), torch.tensor([5, 2])
    for causal in (False, True):
        assert torch.autograd.gradcheck(
            lambda q_, k_, v_: fa.MaskedFlashAttention.apply(
                q_, k_, v_, ql, ml, 0.4, causal), (q, k, v))


def test_cpu_backward_takes_the_plain_version():
    q, k, v, ql, ml = _inputs(16, 16, seed=2)
    before = dict(fa.launch_counts)
    _port_grads(q, k, v, ql, ml, 0.5, True, np.ones((B, 4, 16, D), np.float32))
    assert dict(fa.launch_counts) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol,kernels", [
    (torch.float32, 1e-4, 1e-5, ("masked_attention_bwd_dq", "masked_attention_bwd_dkv")),
    (torch.bfloat16, 1e-3, 2.0 ** -7,
     ("masked_attention_bwd_dq_tc", "masked_attention_bwd_dkv_tc"))])
def test_backward_kernels_match_plain_on_card(cuda_device, dtype, atol, rtol, kernels):
    """Per element atol + rtol * |g_plain|: fp32 sums in another order; in
    bf16 both sum in fp32 and round once, one bf16 ulp apart at most. Each
    backward launches the dtype's dQ and dK/dV kernel once."""
    rng = np.random.default_rng(0)
    cases = [(tq, tk, causal, [tq // 2, tq], [tk, 0])
             for tq, tk, causal in [(240, 240, True), (240, 32, False), (241, 33, False)]]
    # the bf16 dK/dV kernel's narrowed q-tiles: 1, 15, 16, 17, 48, 63, 64,
    # 65 and 97 valid rows, key counts at the same edges, an item with no key
    cases += [(130, 97, False, [1, 15], [97, 48]), (130, 130, True, [16, 17], [63, 64]),
              (130, 130, True, [48, 63], [65, 1]), (97, 130, False, [64, 65], [16, 0]),
              (130, 97, False, [97, 97], [17, 15])]
    for tq, tk, causal, q_lens, m_lens in cases:
        q, do = (torch.from_numpy(rng.standard_normal((2, 4, tq, 64)).astype(np.float32))
                 .to(cuda_device, dtype) for _ in range(2))
        k, v = (torch.from_numpy(rng.standard_normal((2, 4, tk, 64)).astype(np.float32))
                .to(cuda_device, dtype) for _ in range(2))
        ql = torch.tensor(q_lens, dtype=torch.int32, device=cuda_device)
        ml = torch.tensor(m_lens, dtype=torch.int32, device=cuda_device)
        o, m, s = fa.masked_attention_reference(q, k, v, ql, ml, 0.125, causal)
        fa.launch_counts.clear()
        got = fa.masked_flash_attention_backward(q, k, v, ql, ml, o, m, s, do, 0.125, causal)
        assert dict(fa.launch_counts) == {name: 1 for name in kernels}
        want = fa.masked_attention_backward_reference(q, k, v, ql, ml, o, m, s, do,
                                                      0.125, causal)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)
