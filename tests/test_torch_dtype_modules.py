"""The port's modules at compute dtype bfloat16 against the JAX package's at
``dtype=jnp.bfloat16``, on the CPU.

Each flax module is built with ``dtype=jnp.bfloat16`` (and, where it
attends, ``use_pallas=True``: the Pallas kernel in interpret mode keeps P in
fp32 for P·V, as the port's attention does), its variables are randomised
from a numpy seed and carried into the port's module built with
``dtype=torch.bfloat16``, and both run on the same fp32 inputs. Parameters
stay fp32 on both sides.

Tolerance. Both frameworks round at the same places (the flax rounding
points, ``models/layers.py``), but their CPU bf16 products may sum in
another order, and torch's LayerNorm forms its variance by another formula,
so an element near a bf16 rounding edge may land one ulp apart and the
layers after it carry that on. Errors are counted in bf16 ulps of the JAX
element (elements below 1/8 of the output's RMS count at the ulp of that
floor). Measured on this CPU: every bf16 output equal to JAX's (0 ulps:
FFN, both attention blocks, both couplings' outputs, the length head's
logits); the couplings' fp32 logdet within 1.1e-7 relative and the lengths'
fp32 exp-sum within 7.7e-8. Bounds: 2 ulps for a block, 4 for a coupling of
two blocks (room for one rounding-edge flip and its spread), 1e-5 relative
for the logdet, and for the lengths the effect of the logits' measured
difference plus 1e-6 (fp32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaenar_tts_tpu.models import attention as jatt
from vaenar_tts_tpu.models import flow as jflow
from vaenar_tts_tpu.models import layers as jlay
from vaenar_tts_tpu.models import length_predictor as jlen
from vaenar_tts_torch.models import attention as tatt
from vaenar_tts_torch.models import flow as tflow
from vaenar_tts_torch.models import layers as tlay
from vaenar_tts_torch.models import length_predictor as tlen

from test_torch_modules import B, T, carry, lengths, x_of
from torch_threads import one_thread  # noqa: F401

BF16 = torch.bfloat16
BLOCK_ULPS = 2
COUPLING_ULPS = 4


def bf16_ulps(got, want):
    """Largest |got - want| in bf16 ulps of ``want`` (fp32 spacing * 2^16),
    elements below 1/8 of want's RMS counted at the ulp of that floor."""
    want = np.asarray(np.asarray(want, np.float32), np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    floor = np.float32(np.sqrt(np.mean(want.astype(np.float64) ** 2)) / 8)
    ulp = np.spacing(np.maximum(np.abs(want), floor)) * np.float32(2.0 ** 16)
    return float(np.max(np.abs(got.astype(np.float32) - want) / ulp))


def test_ffn_bf16():
    x = x_of(B, 16, 8)
    jm = jlay.FFN(20, 8, dtype=jnp.bfloat16)
    tm = tlay.FFN(8, 20, BF16)
    v = carry(jm, (x,), tm)
    got, want = tm(T(x)), jm.apply(v, x)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert bf16_ulps(got, want) <= BLOCK_ULPS


@pytest.mark.parametrize("block", ["self", "cross"])
def test_attention_blocks_bf16(block):
    x, mem = x_of(B, 16, 16), x_of(B, 8, 24, seed=3)
    ql, ml = lengths(16), lengths(8, seed=4)
    if block == "self":
        jm = jatt.SelfAttentionBlock(16, 16, 2, ffn_hidden=32, dtype=jnp.bfloat16,
                                     use_pallas=True)
        tm = tatt.SelfAttentionBlock(16, 16, 2, ffn_hidden=32, dtype=BF16)
        args = (x, x, ql, ql)
    else:
        jm = jatt.CrossAttentionBlock(16, 16, 2, ffn_hidden=32, dtype=jnp.bfloat16,
                                      use_pallas=True)
        tm = tatt.CrossAttentionBlock(16, 24, 16, 2, ffn_hidden=32, dtype=BF16)
        args = (x, mem, ql, ml)
    v = carry(jm, args, tm)
    want = jm.apply(v, *args)[0]
    got = tm(*(T(a) for a in args))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert bf16_ulps(got, want) <= BLOCK_ULPS


@pytest.mark.parametrize("order", ["upper", "lower"])
def test_coupling_bf16(order):
    """The conditioning net in bf16, the affine coupling and logdet in fp32."""
    z, cond = x_of(B, 16, 8), x_of(B, 8, 12, seed=3)
    zl, cl = lengths(16), lengths(8, seed=4)
    jm = jflow.TransformerCoupling(channels=8, nblk=2, attention_dim=16,
                                   attention_heads=2, temperature=1.0,
                                   ffn_hidden=24, order=order, dtype=jnp.bfloat16,
                                   use_pallas=True)
    tm = tflow.TransformerCoupling(8, 12, 2, 16, 2, 1.0, 24, order=order, dtype=BF16)
    v = carry(jm, (z, cond, zl, cl), tm)
    out, logdet = jm.apply(v, z, cond, zl, cl)
    t_out, t_logdet = tm(T(z), T(cond), T(zl), T(cl))
    assert t_out.dtype == t_logdet.dtype == torch.float32
    assert bf16_ulps(t_out, out) <= COUPLING_ULPS
    np.testing.assert_allclose(t_logdet.detach().numpy(), np.asarray(logdet), rtol=1e-5)


def test_length_head_bf16():
    """bf16 per-token logits within 1 ulp; fp32 exp-sum: lengths within the
    effect of the logits' difference, exp(n_ulps * ulp(max |logit|)) - 1
    relative, plus 1e-6 for the sum's order."""
    x = x_of(B, 16, 16)
    tl = lengths(16)
    jm = jlen.DenseLengthPredictor(dtype=jnp.bfloat16, quantile=0.9)
    tm = tlen.DenseLengthPredictor(16, quantile=0.9, dtype=BF16)
    v = carry(jm, (x, tl), tm)
    logits = jm.apply(v, x, method=lambda m, x: m.projection(x))
    t_logits = tm.projection(T(x))
    assert t_logits.dtype == BF16 and logits.dtype == jnp.bfloat16
    n_ulps = bf16_ulps(t_logits, logits)
    assert n_ulps <= 1
    max_logit = np.float32(np.abs(np.asarray(logits, np.float32)).max())
    rtol = np.expm1(n_ulps * np.spacing(max_logit) * 2.0 ** 16) + 1e-6
    for method in (None, jlen.DenseLengthPredictor.quantile_lengths):
        want = jm.apply(v, x, tl, method=method)
        got = (tm if method is None else tm.quantile_lengths)(T(x), T(tl))
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol)
