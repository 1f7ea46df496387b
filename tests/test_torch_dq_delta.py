"""The plain version of both dQ kernels (fp32 and bf16), and the kernels'
routing.

``masked_attention_dq_reference`` (dq and δ = rowsum(dO∘O) on the rows with
an unmasked key, 0 on the others) is held against the dq of the JAX
package's ``_pallas_backward`` (its Pallas kernels in interpret mode on the
CPU) at the same (o, m, s, dO), at lengths that are multiples of 8 so that
``_block_size`` takes the Pallas path, and its δ against rowsum(dO∘O) in
numpy. Tolerance: atol 1e-5 in fp32 (the sums run in another order). The
kernels themselves run only on a CUDA card:
``test_dq_kernel_matches_plain_on_card``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaenar_tts_tpu.ops import flash_attention as jax_fa
from vaenar_tts_torch.ops import flash_attention as fa

B, H = 2, 2
ATOL = 1e-5
# (Tq, Tk, causal, q_len, m_len); None is the full length
CASES = {
    "ragged": (40, 32, False, [33, 40], [19, 32]),
    "causal": (40, 40, True, [40, 27], [40, 31]),
    "no_key_item": (32, 24, False, [32, 20], [24, 0]),
    "q_len_below_tq": (24, 40, False, [16, 9], None),
}
PARAMS = [(name, d) for name in CASES for d in (8, 64)]


def _case(name, d):
    """Inputs made from a seed, and the forward's (o, m, s) from the plain
    version, as torch tensors."""
    tq, tk, causal, ql, ml = CASES[name]
    rng = np.random.default_rng(len(name) + d)
    q, g = (rng.standard_normal((B, H, tq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, H, tk, d)).astype(np.float32) for _ in range(2))
    ql = None if ql is None else torch.tensor(ql, dtype=torch.int32)
    ml = None if ml is None else torch.tensor(ml, dtype=torch.int32)
    q, k, v, g = (torch.from_numpy(x) for x in (q, k, v, g))
    scale = 1.0 / np.sqrt(d)
    o, m, s = fa.masked_attention_reference(q, k, v, ql, ml, scale, causal)
    return dict(q=q, k=k, v=v, g=g, ql=ql, ml=ml, o=o, m=m, s=s, scale=scale,
                causal=causal)


@pytest.fixture(scope="module")
def jax_dq():
    """{(case, D): dq of the JAX package's _pallas_backward} at each case's
    inputs, all computed once for the module."""
    out = {}
    for name, d in PARAMS:
        c = _case(name, d)
        tq, tk = c["q"].shape[2], c["k"].shape[2]
        assert jax_fa._block_size(tq) and jax_fa._block_size(tk)
        jql, jml = jax_fa._default_lengths(
            None if c["ql"] is None else jnp.asarray(c["ql"].numpy()),
            None if c["ml"] is None else jnp.asarray(c["ml"].numpy()), B, tq, tk)
        q, k, v, g, o = (jnp.asarray(c[x].numpy()) for x in ("q", "k", "v", "g", "o"))
        m, s = (jnp.asarray(c[x].numpy())[..., None] for x in ("m", "s"))
        dq, _, _ = jax_fa._pallas_backward(q, k, v, jql, jml, o, m, s, g, c["scale"],
                                           c["causal"])
        out[name, d] = np.asarray(dq)
    return out


@pytest.mark.parametrize("name,d", PARAMS)
def test_dq_reference_matches_pallas_backward(jax_dq, name, d):
    c = _case(name, d)
    dq, delta = fa.masked_attention_dq_reference(
        c["q"], c["k"], c["v"], c["g"], c["o"], c["ql"], c["ml"], c["m"], c["s"],
        c["scale"], c["causal"])
    np.testing.assert_allclose(dq.numpy(), jax_dq[name, d], atol=ATOL)

    tq = c["q"].shape[2]
    ql = np.full(B, tq) if c["ql"] is None else c["ql"].numpy()
    ml = np.full(B, c["k"].shape[2]) if c["ml"] is None else c["ml"].numpy()
    has_key = (np.arange(tq)[None, :] < ql[:, None]) & (ml[:, None] > 0)  # [B, Tq]
    want = np.where(has_key[:, None, :], (c["g"].numpy() * c["o"].numpy()).sum(-1), 0.0)
    assert delta.dtype == torch.float32 and delta.shape == (B, H, tq)
    np.testing.assert_allclose(delta.numpy(), want, atol=ATOL)
    np.testing.assert_array_equal(delta.numpy()[~np.broadcast_to(
        has_key[:, None, :], delta.shape)], 0.0)


@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_routing(kind, dtype):
    """bf16 takes the tensor-core kernels, fp32 the fp32-FMA ones; the dQ
    kernel of either dtype forms δ, the dK/dV kernels read it."""
    base = "masked_attention_fwd" if kind == "fwd" else f"masked_attention_bwd_{kind}"
    want = f"{base}_tc" if dtype == torch.bfloat16 else base
    assert fa.kernel_name(kind, dtype) == want
    forms_delta = fa.kernel_name(kind, dtype) in fa.DELTA_FORMING_KERNELS
    assert forms_delta == (kind == "dq")


@pytest.mark.parametrize("kind,dtype,give_o", [("dq", torch.bfloat16, False),
                                                ("dq", torch.float32, False),
                                                ("dkv", torch.bfloat16, True),
                                                ("dkv", torch.float32, True)])
def test_launch_refuses_a_wrong_o(kind, dtype, give_o):
    """Only a kernel of DELTA_FORMING_KERNELS is given o: a launch that
    would pass the kernel one pointer too many or too few raises before it
    reaches the library."""
    q = torch.zeros((1, 1, 8, 64), dtype=dtype)
    stat = torch.zeros((1, 1, 8))
    outs = (torch.empty_like(q),) if kind == "dq" else (torch.empty_like(q),) * 2
    with pytest.raises(ValueError, match="o$"):
        fa.launch_backward_kernel(kind, q, q, q, q, None, None, stat, stat, stat, outs,
                                  0.125, False, o=q if give_o else None)


def test_bf16_cpu_gradients_are_the_plain_backward():
    """On CPU tensors the bf16 autograd Function takes the plain backward."""
    c = _case("causal", 64)
    q, k, v, g = (c[x].to(torch.bfloat16) for x in ("q", "k", "v", "g"))
    o, m, s = fa.masked_attention_reference(q, k, v, c["ql"], c["ml"], 0.125, True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(fa.launch_counts)
    out = fa.MaskedFlashAttention.apply(*leaves, c["ql"], c["ml"], 0.125, True)
    (out.float() * g.float()).sum().backward()
    want = fa.masked_attention_backward_reference(q, k, v, c["ql"], c["ml"], o, m, s,
                                                  g, 0.125, True)
    assert dict(fa.launch_counts) == before
    assert torch.equal(out, o)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.bfloat16
        assert torch.equal(leaf.grad, w)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the dQ kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol,kernel", [
    (torch.float32, 1e-4, 1e-5, "masked_attention_bwd_dq"),
    (torch.bfloat16, 1e-3, 2.0 ** -7, "masked_attention_bwd_dq_tc")])
def test_dq_kernel_matches_plain_on_card(cuda_device, dtype, atol, rtol, kernel):
    """The dQ kernel alone against masked_attention_dq_reference: dq per
    element within atol + rtol·|dq| (fp32: the order of the sums; bf16: one
    bf16 ulp and the fp32 order), δ within 1e-5 + 1e-5·|δ| (the order of a
    64-term fp32 sum), every δ element written."""
    rng = np.random.default_rng(0)
    for tq, tk, causal in [(240, 240, True), (240, 32, False), (241, 33, False)]:
        q, do = (torch.from_numpy(rng.standard_normal((2, 4, tq, 64)).astype(np.float32))
                 .to(cuda_device, dtype) for _ in range(2))
        k, v = (torch.from_numpy(rng.standard_normal((2, 4, tk, 64)).astype(np.float32))
                .to(cuda_device, dtype) for _ in range(2))
        ql = torch.tensor([tq // 2, tq], dtype=torch.int32, device=cuda_device)
        ml = torch.tensor([tk, 0], dtype=torch.int32, device=cuda_device)
        o, m, s = fa.masked_attention_reference(q, k, v, ql, ml, 0.125, causal)
        dq, delta = torch.empty_like(q), torch.full_like(m, float("nan"))
        fa.launch_counts.clear()
        fa.launch_backward_kernel("dq", q, k, v, do, ql, ml, m, s, delta, (dq,), 0.125,
                                  causal, o=o)
        assert dict(fa.launch_counts) == {kernel: 1}
        dq_want, delta_want = fa.masked_attention_dq_reference(q, k, v, do, o, ql, ml, m, s,
                                                               0.125, causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(dq.float(), dq_want.float(), atol=atol, rtol=rtol)
        torch.testing.assert_close(delta, delta_want, atol=1e-5, rtol=1e-5)
