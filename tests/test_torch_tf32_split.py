"""3xTF32: a torch emulation of the arithmetic of the fp32 forward kernel at
D >= 128 (``csrc/masked_attention_fwd_3xtf32.cu``) against the JAX
package's masked attention on the CPU, and the lists that name that kernel
(chip_smoke.py's ``TF32X3_KERNELS``) and patch it
(``scripts/torch_fwd_3xtf32_ablation.py``).

The kernel splits each fp32 operand x of both products, S = Q.K^T and
O = P.V, into two TF32 values (10 mantissa bits): big = x with its low 13
bits cleared, and small = rna(x - big), rounded to nearest with ties away
from zero on the bits, (bits + 0x1000) & ~0x1fff (what cvt.rna.tf32.f32
does). Each product is small.big + big.small + big.big, summed in fp32; the
scale, the mask and the softmax stay fp32. Emulated here on the int32 view
of fp32 tensors: a product of two TF32 values is exact in fp32, so each of
the three products is an fp32 matmul of split operands (the tensor core's
own accumulation, which truncates, is not emulated: the kernel keeps it to
one 64-column panel, and the checks on the card hold what it adds). Held against ``masked_attention_xla``
within chip_smoke.py's fp32 tolerance of the kernel against its plain
version (``TOL_O["float32"]``), and m and s against the port's plain
version (``TOL_M``, ``TOL_S_REL``), at D = 128, 256 and 384, causal and not,
with logits of standard deviation 1 (the checks' randn at scale D^-1/2)
and 8 (chip_smoke.py's ``LARGE_LOGIT_STD``: |S| up to a few tens). One
TF32 product an operand pair misses the same bound by at least 10x on the
large logits.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_threads import one_thread  # noqa: F401
from vaenar_tts_tpu.models.attention import attention_mask as jax_attention_mask
from vaenar_tts_tpu.models.attention import masked_attention_xla
from vaenar_tts_torch.ops import flash_attention as fa

B, H, T = 2, 1, 70
Q_LENGTHS, M_LENGTHS = (70, 45), (70, 30)
LARGE_STD = chip_smoke.LARGE_LOGIT_STD["large_logits_130"]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest, ties away."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = (x.view(torch.int32) & ~0x1FFF).view(torch.float32)
    return big, tf32_rna(x - big)


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the kernel forms it: 3 TF32 products, small terms first, or
    one TF32 product of operands rounded to nearest (``passes`` = 1)."""
    if passes == 1:
        return tf32_rna(a) @ tf32_rna(b)
    (a_big, a_small), (b_big, b_small) = split(a), split(b)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def emulated_forward(q, k, v, q_lengths, m_lengths, scale, causal, passes=3):
    """(o, m, s) with the kernel's arithmetic; the rest as the plain
    version (fp32 softmax, masked logits NEG, m the row max)."""
    logits = product(q, k.transpose(-1, -2), passes) * scale
    mask = fa.attention_mask(q_lengths, m_lengths, q.shape[0], q.shape[2], k.shape[2], causal,
                             q.device)
    logits = logits.masked_fill(~mask, fa.NEG)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(dim=-1, keepdim=True)
    return product(p, v, passes) / s, m[..., 0], s[..., 0]


def tf32_shares(D, causal, logit_std, seed):
    """The largest share of chip_smoke.py's fp32 o tolerance that the
    emulated kernel (3 products) and one TF32 product reach against the JAX
    package's masked attention, and the 3-product m and s errors against the
    port's plain version."""
    rng = np.random.default_rng(seed)
    gain = np.float32(np.sqrt(logit_std))
    q = (rng.standard_normal((B, H, T, D)) * gain).astype(np.float32)
    k = (rng.standard_normal((B, H, T, D)) * gain).astype(np.float32)
    v = rng.standard_normal((B, H, T, D)).astype(np.float32)
    ql, ml = np.asarray(Q_LENGTHS, np.int32), np.asarray(M_LENGTHS, np.int32)
    scale = D ** -0.5
    mask = jax_attention_mask(jnp.asarray(ql), jnp.asarray(ml), B, T, T, causal)
    ref, _ = masked_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask, scale)
    ref = torch.from_numpy(np.array(ref))
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(ql),
            torch.from_numpy(ml), scale, causal)
    atol, rtol = chip_smoke.TOL_O["float32"]
    shares = {}
    for passes in (3, 1):
        o, m, s = emulated_forward(*args, passes=passes)
        shares[passes] = ((o - ref).abs() / (atol + rtol * ref.abs())).max().item()
        if passes == 3:
            _, m_ref, s_ref = fa.masked_attention_reference(*args)
            errs = ((m - m_ref).abs().max().item(), ((s - s_ref).abs() / s_ref).max().item())
    return shares, errs, (q @ k.transpose(0, 1, 3, 2) * scale).std()


@pytest.mark.parametrize("logit_std", [1.0, LARGE_STD])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [128, 256, 384])
def test_3xtf32_holds_the_fp32_tolerance(D, causal, logit_std):
    shares, (err_m, err_s), std = tf32_shares(D, causal, logit_std, seed=D + causal)
    assert abs(std / logit_std - 1) < 0.2  # the logits are as large as stated
    assert shares[3] <= 1.0, shares
    assert err_m <= chip_smoke.TOL_M and err_s <= chip_smoke.TOL_S_REL, (err_m, err_s)
    if logit_std == LARGE_STD:
        assert shares[1] >= 10.0, shares  # one TF32 product misses it by 10x


@pytest.mark.parametrize("D", [64, 128, 256, 384, 512])
def test_3xtf32_kernels_are_the_fp32_forward_from_128(D):
    """chip_smoke.py bounds the fp32 forward at PEAK_3XTF32 at every width
    the 3xTF32 kernel serves, and the D = 64 SIMT forward at the SIMT rate."""
    name = fa.kernel_name("fwd", torch.float32, D)
    assert (name in chip_smoke.TF32X3_KERNELS) == (D >= 128), name


def test_ablation_patches_apply_once():
    """Every string patch of scripts/torch_fwd_3xtf32_ablation.py finds its
    text exactly once in the kernel source, as the script asserts on the
    card (an edit of the kernel can leave a patch stale)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_fwd_3xtf32_ablation", os.path.join(root, "scripts", "torch_fwd_3xtf32_ablation.py"))
    ablation = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablation)
    with open(os.path.join(root, ablation.KERNEL)) as f:
        src = f.read()
    counts = {(name, old[:60]): src.count(old) for name, patches in ablation.ABLATIONS.items()
              for old, _ in patches}
    assert len(counts) >= 12 and all(n == 1 for n in counts.values()), counts
