"""Masked attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of the forward half of ``vaenar_tts_tpu/ops/flash_attention.py``
(``_fwd_kernel`` and ``_fwd_kernel_blocked``). One contract for both:

* logits = q·kᵀ·scale over q, k, v of shape [B, H, T, D];
* the mask is ``row < q_len[b] and col < m_len[b]`` (and ``col <= row`` when
  causal); a length of None means the full length;
* masked logits become NEG = -2³²+1, not -inf, so a row with no unmasked
  logit comes out uniform over the Tk keys (o = mean(v), m = NEG, s = Tk);
* the softmax is fp32 and the row statistics (max m, sum of exp s) are
  returned as fp32 [B, H, Tq] beside o, which has q's dtype.

``masked_flash_attention`` launches ``csrc/masked_attention_fwd.cu`` on a
CUDA tensor, and raises if it cannot. On a CPU tensor, and only there, it
calls ``masked_attention_reference``, which has the same signature.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import torch

NEG = -2.0 ** 32 + 1.0
KERNEL_HEAD_DIMS = (64,)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# launches of each hand-written kernel in this process; callers reset it
launch_counts: Counter = Counter()


def attention_mask(q_lengths: Optional[torch.Tensor],
                   m_lengths: Optional[torch.Tensor], batch: int, tq: int,
                   tk: int, causal: bool, device) -> torch.Tensor:
    """[B, 1, Tq, Tk] boolean mask, True where attention is allowed."""
    rows = torch.arange(tq, device=device)
    cols = torch.arange(tk, device=device)
    mask = torch.ones((batch, 1, tq, tk), dtype=torch.bool, device=device)
    if q_lengths is not None:
        mask = mask & (rows[None, :] < q_lengths[:, None])[:, None, :, None]
    if m_lengths is not None:
        mask = mask & (cols[None, :] < m_lengths[:, None])[:, None, None, :]
    if causal:
        mask = mask & (cols[None, :] <= rows[:, None])[None, None]
    return mask


def masked_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               q_lengths: Optional[torch.Tensor],
                               m_lengths: Optional[torch.Tensor],
                               scale: float, causal: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """The plain PyTorch version of the kernel: (o, m, s)."""
    B, _, Tq, _ = q.shape
    Tk = k.shape[2]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = attention_mask(q_lengths, m_lengths, B, Tq, Tk, causal, q.device)
    logits = logits.masked_fill(~mask, NEG)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p / s, v.float())
    return o.to(q.dtype), m[..., 0], s[..., 0]


def _check_lengths(lengths: Optional[torch.Tensor], batch: int,
                   device: torch.device, name: str) -> Optional[torch.Tensor]:
    if lengths is None:
        return None
    if lengths.shape != (batch,) or lengths.device != device:
        raise ValueError(f"{name} must be [{batch}] on {device}; got "
                         f"{tuple(lengths.shape)} on {lengths.device}")
    return lengths.to(torch.int32).contiguous()


def masked_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_lengths: Optional[torch.Tensor] = None,
                           m_lengths: Optional[torch.Tensor] = None,
                           scale: float = 1.0, causal: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Masked attention; returns (o [B,H,Tq,D] in q's dtype, m and s fp32
    [B,H,Tq]). CPU tensors take the plain version; CUDA tensors launch the
    kernel on the current stream or raise."""
    if q.device.type == "cpu":
        return masked_attention_reference(q, k, v, q_lengths, m_lengths,
                                          scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"masked_flash_attention runs on cuda or cpu, "
                         f"not {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, T, D]")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel takes head widths {KERNEL_HEAD_DIMS}; "
                         f"got {D}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes one dtype of {KERNEL_DTYPES} for "
                         f"q, k, v; got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if B == 0 or H == 0 or Tq == 0 or Tk == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    ql = _check_lengths(q_lengths, B, q.device, "q_lengths")
    ml = _check_lengths(m_lengths, B, q.device, "m_lengths")

    from . import _build
    lib = _build.load_library()
    o = torch.empty_like(q)
    m = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    s = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.masked_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ql.data_ptr() if ql is not None else None,
            ml.data_ptr() if ml is not None else None,
            o.data_ptr(), m.data_ptr(), s.data_ptr(),
            B, H, Tq, Tk, D, float(scale), int(bool(causal)),
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"masked_attention_fwd launch failed: CUDA error {err}")
    launch_counts["masked_attention_fwd"] += 1
    return o, m, s
