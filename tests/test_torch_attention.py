"""The port's masked attention against the JAX package's.

``masked_attention_reference`` (the plain version of the CUDA kernel, which
``masked_flash_attention`` takes on CPU tensors) is held against
``masked_attention_xla`` and the Pallas ``masked_flash_attention`` (interpret
mode on the CPU) for O, and against ``_pallas_forward(..., with_stats=True)``
for the row statistics m and s. Tolerance: atol 2e-5 in fp32, as in
tests/test_flash_attention.py (the sums run in another order). The kernel
itself runs only on a CUDA card: ``test_kernel_matches_plain_on_card``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaenar_tts_tpu.models.attention import attention_mask as jax_attention_mask
from vaenar_tts_tpu.models.attention import masked_attention_xla
from vaenar_tts_tpu.ops import flash_attention as jax_fa
from vaenar_tts_torch.ops import _build
from vaenar_tts_torch.ops import flash_attention as fa

B, H, D = 2, 4, 16
ATOL = 2e-5


def _inputs(tq, tk, seed, q_lengths="random", m_lengths="random"):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, tq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, tk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, tk, D)).astype(np.float32)
    lens = {"random": lambda t: rng.integers(1, t + 1, (B,)).astype(np.int32),
            "none": lambda t: None}
    ql = lens[q_lengths](tq) if isinstance(q_lengths, str) else np.asarray(q_lengths, np.int32)
    ml = lens[m_lengths](tk) if isinstance(m_lengths, str) else np.asarray(m_lengths, np.int32)
    return q, k, v, ql, ml


def _torch(x):
    return None if x is None else torch.from_numpy(x)


def _jax(x):
    return None if x is None else jnp.asarray(x)


CASES = {
    "causal": dict(tq=64, tk=64, causal=True),
    "cross": dict(tq=64, tk=48, causal=False),
    "long_cross": dict(tq=128, tk=96, causal=False),
    "fully_masked_rows": dict(tq=64, tk=64, causal=True, q_lengths=[20, 64],
                              m_lengths=[64, 17]),
    "empty_memory": dict(tq=64, tk=48, causal=False, q_lengths=[64, 30],
                         m_lengths=[0, 48]),
    "none_lengths": dict(tq=64, tk=64, causal=False, q_lengths="none",
                         m_lengths="none"),
    "none_lengths_causal": dict(tq=64, tk=64, causal=True, q_lengths="none",
                                m_lengths="none"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_jax_with_stats(name):
    case = dict(CASES[name])
    causal = case.pop("causal")
    tq, tk = case["tq"], case["tk"]
    q, k, v, ql, ml = _inputs(seed=len(name), **case)
    scale = 1.0 / np.sqrt(D)

    o, m, s = fa.masked_attention_reference(
        _torch(q), _torch(k), _torch(v), _torch(ql), _torch(ml), scale, causal)
    assert o.shape == (B, H, tq, D) and m.shape == s.shape == (B, H, tq)

    mask = jax_attention_mask(_jax(ql), _jax(ml), B, tq, tk, causal)
    ref, _ = masked_attention_xla(_jax(q), _jax(k), _jax(v), mask, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=ATOL)

    pallas = jax_fa.masked_flash_attention(_jax(q), _jax(k), _jax(v), _jax(ql),
                                           _jax(ml), scale, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(pallas), atol=ATOL)

    jql, jml = jax_fa._default_lengths(_jax(ql), _jax(ml), B, tq, tk)
    _, jm, js = jax_fa._pallas_forward(_jax(q), _jax(k), _jax(v), jql, jml,
                                       scale, causal, with_stats=True)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm)[..., 0], atol=ATOL,
                               rtol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js)[..., 0], atol=ATOL,
                               rtol=1e-5)


def test_ragged_tq_matches_jax():
    """Tq = 60 has no 8-aligned divisor block: the JAX package falls back to
    XLA there (without stats); the port has one path for every shape."""
    q, k, v, ql, ml = _inputs(60, 48, seed=5)
    scale = 0.3
    o, m, s = fa.masked_attention_reference(
        _torch(q), _torch(k), _torch(v), _torch(ql), _torch(ml), scale, False)
    ref = jax_fa.masked_flash_attention(_jax(q), _jax(k), _jax(v), _jax(ql),
                                        _jax(ml), scale, False)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=ATOL)


def test_fully_masked_rows_are_uniform():
    q, k, v, ql, ml = _inputs(32, 24, seed=9, q_lengths=[10, 32], m_lengths=[24, 0])
    o, m, s = fa.masked_attention_reference(
        _torch(q), _torch(k), _torch(v), _torch(ql), _torch(ml), 0.25, False)
    mean_v = v.mean(axis=2)
    np.testing.assert_allclose(o[0, :, 10:].numpy(),
                               np.broadcast_to(mean_v[0, :, None], (H, 22, D)),
                               atol=ATOL)
    np.testing.assert_allclose(o[1].numpy(),
                               np.broadcast_to(mean_v[1, :, None], (H, 32, D)),
                               atol=ATOL)
    assert torch.all(m[0, :, 10:] == fa.NEG) and torch.all(s[1] == 24.0)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, ql, ml = _inputs(16, 16, seed=2)
    before = fa.launch_counts["masked_attention_fwd"]
    got = fa.masked_flash_attention(_torch(q), _torch(k), _torch(v), _torch(ql),
                                    _torch(ml), scale=0.5, causal=True)
    want = fa.masked_attention_reference(_torch(q), _torch(k), _torch(v),
                                         _torch(ql), _torch(ml), 0.5, True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fa.launch_counts["masked_attention_fwd"] == before


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_on_card(cuda_device, dtype, atol):
    """fp32: sums in another order (1e-4); bf16: o is rounded to bf16 (2e-2)."""
    rng = np.random.default_rng(0)
    for tq, tk, causal in [(160, 160, False), (1681, 157, False), (300, 300, True)]:
        q, k, v = (torch.from_numpy(rng.standard_normal((2, 4, t, 64)).astype(np.float32))
                   .to(cuda_device, dtype) for t in (tq, tk, tk))
        ql = torch.tensor([tq // 2, tq], dtype=torch.int32, device=cuda_device)
        ml = torch.tensor([tk, tk // 3], dtype=torch.int32, device=cuda_device)
        got = fa.masked_flash_attention(q, k, v, ql, ml, 0.125, causal)
        want = fa.masked_attention_reference(q, k, v, ql, ml, 0.125, causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol, rtol=0)
        torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(got[2], want[2], atol=1e-3, rtol=1e-4)
