"""Masked attention: the CUDA kernels' wrappers, their plain versions, and
the autograd Function that joins them.

Counterpart of ``vaenar_tts_tpu/ops/flash_attention.py``: the forward
(``_fwd_kernel`` and ``_fwd_kernel_blocked``), the backward (``_dq_kernel``
and ``_dkv_kernel``) and the ``masked_flash_attention`` custom VJP. One
contract for all:

* logits = q·kᵀ·scale over q, k, v of shape [B, H, T, D];
* the mask is ``row < q_len[b] and col < m_len[b]`` (and ``col <= row`` when
  causal); a length of None means the full length;
* masked logits become NEG = -2³²+1, not -inf, so a row with no unmasked
  logit comes out uniform over the Tk keys (o = mean(v), m = NEG, s = Tk);
* the softmax is fp32 and the row statistics (max m, sum of exp s) are
  returned as fp32 [B, H, Tq] beside o, which has q's dtype.

* the backward recomputes P = exp(where(mask, logits, NEG) - m) / s from
  those statistics; dV = Pᵀ·dO counts every row, fully masked ones too, and
  dS = P∘(dO·Vᵀ - δ) is zeroed at masked positions, δ = rowsum(dO∘O).

Which kernel serves which dtype, on CUDA tensors (``launch_counts`` key):

* bf16 (the shipped ``compute_dtype``): the forward
  ``csrc/masked_attention_fwd_tc.cu`` (``masked_attention_fwd_tc``), the dQ
  kernel ``csrc/masked_attention_bwd_dq_tc.cu``
  (``masked_attention_bwd_dq_tc``) and the dK/dV kernel
  ``csrc/masked_attention_bwd_dkv_tc.cu`` (``masked_attention_bwd_dkv_tc``),
  all on the tensor cores;
* fp32: the forward ``csrc/masked_attention_fwd.cu``
  (``masked_attention_fwd``), the dQ kernel ``csrc/masked_attention_bwd.cu``
  (``masked_attention_bwd_dq``) and the dK/dV kernel
  ``csrc/masked_attention_bwd_dkv.cu`` (``masked_attention_bwd_dkv``), fp32
  FMAs, but for the forward at D = 128 and above
  (``csrc/masked_attention_fwd_3xtf32.cu``), which runs on the tensor cores
  in 3xTF32: each fp32 operand split into two TF32 parts and three products
  summed, within the fp32 reference's tolerance, which one TF32 product
  would not meet.

In both dtypes the dQ kernel also reads O and forms δ, which the dK/dV
kernel launched after it reads: no separate δ pass runs on the card.

Head widths: each kernel is compiled for D = 64, 128 and 256
(``KERNEL_HEAD_DIMS``), and its C function runs the one its D argument
names. The D = 128 and D = 256 launches count under the key with
``_d128`` or ``_d256`` appended (``masked_attention_fwd_tc_d256``, ...). At
D = 256 each kernel's grid but the fp32 forward's (below) has an axis over
two slices of 128 output columns (the C sources say why); one launch
covers both. Above 256 there
is no upper width: every multiple of 128 (``WIDE_STEP``) runs on one wide
kernel a pass and dtype (``csrc/masked_attention_wide_tc.cu`` for bf16,
``csrc/masked_attention_wide.cu`` for the fp32 backward), which takes the
width at run time, and its launches count under the key with ``_wide``
appended (``WIDE_SUFFIX``) at every width. The wide backward's grid has an
axis over the D / 128 output slices, and no block holds an operand at the
full width: the D = 256 kernels keep Q, K (and dO, V) whole, which at
D = 384 would take more shared memory than a block has, so the wide
backward kernels stream them in panels of 64 columns. Both forwards above
that form S once for up to 512 output columns, so their grids have
ceil(D / 512) slices, and split a q-block's key tiles over a cluster of
blocks when the grid is small: the bf16 wide forward, with a warp group for
each 128 of a slice's columns and Q held whole up to D = 512, and the fp32
forward at D = 128 and above, one 3xTF32 kernel
(``csrc/masked_attention_fwd_3xtf32.cu``, counted under
``masked_attention_fwd_d128``, ``masked_attention_fwd_d256`` and
``masked_attention_fwd_wide``). Every other width runs on the next native width
(``kernel_width``: 1-64 at 64, 65-128 at 128, 129-256 at 256, above that
the next multiple of 128): q, k and v (and o and dO in the backward) are
padded with zero columns (``pad_head_width``), the scale is left as the
caller gave it, and o, dq, dk and dv are sliced back. That is exact: a
zero column adds nothing to a score, and the output and gradient columns
it adds are zero. A width below 1 raises.

``masked_flash_attention`` and ``masked_flash_attention_backward`` launch
them and raise if they cannot; there is no fall back. On CPU tensors, and
only there, they call ``masked_attention_reference`` and
``masked_attention_backward_reference``, which have the same signatures;
``masked_attention_dq_reference`` is the plain version of either dQ kernel
alone (dq and δ), which the checks on the card hold them against.
``MaskedFlashAttention`` is the differentiable op the model calls.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG = -2.0 ** 32 + 1.0
# the head widths each kernel is compiled for, and the suffix of their
# launch_counts keys
KERNEL_HEAD_DIMS = (64, 128, 256)
WIDTH_SUFFIX = {64: "", 128: "_d128", 256: "_d256"}
# above the widest of those there is no upper width: every multiple of
# WIDE_STEP runs on the wide kernels, whose launches count under
# WIDE_SUFFIX at every width
WIDE_STEP = 128
WIDE_SUFFIX = "_wide"
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# launches of each hand-written kernel in this process; callers reset it
launch_counts: Counter = Counter()

# the backward kernels that read O and write δ themselves (both dQ
# kernels, at every width); every other one reads the δ they wrote
DELTA_FORMING_KERNELS = frozenset(
    f"{base}{suffix}" for base in ("masked_attention_bwd_dq", "masked_attention_bwd_dq_tc")
    for suffix in (*WIDTH_SUFFIX.values(), WIDE_SUFFIX))


def kernel_width(head_dim: int) -> int:
    """The native width a head width runs at: the least of
    ``KERNEL_HEAD_DIMS`` at or above it (64 for 1-64, 128 for 65-128, 256
    for 129-256), and above 256 the next multiple of ``WIDE_STEP`` (384
    for 257-384, 512 for 385-512, ...). Raises for a width below 1."""
    if head_dim < 1:
        raise ValueError(f"the attention kernels take head widths of 1 and more (native "
                         f"{KERNEL_HEAD_DIMS} and every multiple of {WIDE_STEP} above, others "
                         f"padded with zero columns to the next); got {head_dim}")
    for width in KERNEL_HEAD_DIMS:
        if head_dim <= width:
            return width
    return -(-head_dim // WIDE_STEP) * WIDE_STEP


def is_native_width(head_dim: int) -> bool:
    """Whether a kernel runs at ``head_dim`` itself, without padding."""
    return head_dim >= 1 and kernel_width(head_dim) == head_dim


def pad_head_width(width: int, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``tensors`` with zero columns appended to their last dimension up to
    ``width``; a tensor already that wide is returned as it is."""
    return tuple(t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))
                 for t in tensors)


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


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 for the kernels' dtypes; float64 stays float64 (gradcheck)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def masked_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               q_lengths: Optional[torch.Tensor],
                               m_lengths: Optional[torch.Tensor],
                               scale: float, causal: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """The plain PyTorch version of the forward kernel: (o, m, s)."""
    B, _, Tq, _ = q.shape
    Tk = k.shape[2]
    acc = _acc_dtype(q.dtype)
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    mask = attention_mask(q_lengths, m_lengths, B, Tq, Tk, causal, q.device)
    logits = logits.masked_fill(~mask, NEG)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p / s, v.to(acc))
    return o.to(q.dtype), m[..., 0], s[..., 0]


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """δ = rowsum(dO∘O), fp32 [B, H, Tq], as the JAX package computes it
    outside its kernels (``_pallas_backward``): the plain backward's δ. On
    the card the dQ kernels form it themselves."""
    acc = _acc_dtype(o.dtype)
    return (do.to(acc) * o.to(acc)).sum(dim=-1)


def _backward_terms(q, k, v, q_lengths, m_lengths, o, m, s, do, scale,
                    causal):
    """(P, dS, δ) of the plain backward in the accumulation dtype; δ is 0 on
    the rows with no unmasked key, whose dS is 0."""
    B, _, Tq, _ = q.shape
    Tk = k.shape[2]
    acc = _acc_dtype(q.dtype)
    mask = attention_mask(q_lengths, m_lengths, B, Tq, Tk, causal, q.device)
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    logits = logits.masked_fill(~mask, NEG)
    p = torch.exp(logits - m[..., None]) / s[..., None]
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    zero = torch.zeros((), dtype=acc, device=q.device)
    delta = torch.where(mask.any(dim=-1), attention_delta(o, do), zero)
    ds = torch.where(mask, p * (dp - delta[..., None]), zero)
    return p, ds, delta


def masked_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        q_lengths: Optional[torch.Tensor], m_lengths: Optional[torch.Tensor],
        o: torch.Tensor, m: torch.Tensor, s: torch.Tensor, do: torch.Tensor,
        scale: float, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the backward kernels: (dq, dk, dv) from
    the forward's (o, m, s) and the gradient ``do`` of o."""
    p, ds, _ = _backward_terms(q, k, v, q_lengths, m_lengths, o, m, s, do,
                               scale, causal)
    acc = p.dtype
    dv = torch.matmul(p.transpose(-1, -2), do.to(acc))
    dq = torch.matmul(ds, k.to(acc)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def masked_attention_dq_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
        o: torch.Tensor, q_lengths: Optional[torch.Tensor],
        m_lengths: Optional[torch.Tensor], m: torch.Tensor, s: torch.Tensor,
        scale: float, causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of both dQ kernels (fp32 and bf16): (dq in
    q's dtype, δ fp32 [B, H, Tq]), δ = rowsum(dO∘O) on the rows that have
    an unmasked key and 0 on the others."""
    _, ds, delta = _backward_terms(q, k, v, q_lengths, m_lengths, o, m, s, do,
                                   scale, causal)
    return (torch.matmul(ds, k.to(ds.dtype)) * scale).to(q.dtype), delta


def _check_lengths(lengths: Optional[torch.Tensor], batch: int,
                   device: torch.device, name: str) -> Optional[torch.Tensor]:
    if lengths is None:
        return None
    if lengths.shape != (batch,) or lengths.device != device:
        raise ValueError(f"{name} must be [{batch}] on {device}; got "
                         f"{tuple(lengths.shape)} on {lengths.device}")
    return lengths.to(torch.int32).contiguous()


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *more: torch.Tensor) -> None:
    """Raise on anything the kernels do not take: q (and ``more``, shaped
    like q) [B, H, Tq, D], k and v [B, H, Tk, D], one CUDA device, one dtype
    of KERNEL_DTYPES, D that ``kernel_width`` takes (1 and more),
    contiguous, not empty."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, T, D]")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if (k.shape != (B, H, Tk, D) or v.shape != k.shape
            or any(t.shape != q.shape for t in more)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"{[tuple(t.shape) for t in more]}")
    kernel_width(D)
    tensors = (q, k, v, *more)
    if q.dtype not in KERNEL_DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"the kernel takes one dtype of {KERNEL_DTYPES}; got "
                         f"{[t.dtype for t in tensors]}")
    if any(t.device != q.device for t in tensors):
        raise ValueError("the kernel's tensors must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel's tensors must be contiguous")
    if B == 0 or H == 0 or Tq == 0 or Tk == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")


def _check_device(q: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (the plain version), False for CUDA (the
    kernel); raise on any other device."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    return False


def masked_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_lengths: Optional[torch.Tensor] = None,
                           m_lengths: Optional[torch.Tensor] = None,
                           scale: float = 1.0, causal: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Masked attention; returns (o [B,H,Tq,D] in q's dtype, m and s fp32
    [B,H,Tq]). CPU tensors take the plain version; CUDA tensors launch the
    kernel of width ``kernel_width(D)`` on the current stream, q, k and v
    zero-padded to it and o sliced back (contiguous), or raise."""
    if _check_device(q, "masked_flash_attention"):
        return masked_attention_reference(q, k, v, q_lengths, m_lengths,
                                          scale, causal)
    _check_kernel_inputs(q, k, v)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    width = kernel_width(D)
    q, k, v = pad_head_width(width, q, k, v)
    ql = _check_lengths(q_lengths, B, q.device, "q_lengths")
    ml = _check_lengths(m_lengths, B, q.device, "m_lengths")

    o = torch.empty_like(q)
    m = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    s = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch(kernel_name("fwd", q.dtype, width), (q, k, v, ql, ml, o, m, s),
                B, H, Tq, Tk, width, scale, causal)
    return (o if width == D else o[..., :D].contiguous()), m, s


def masked_flash_attention_backward(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        q_lengths: Optional[torch.Tensor], m_lengths: Optional[torch.Tensor],
        o: torch.Tensor, m: torch.Tensor, s: torch.Tensor, do: torch.Tensor,
        scale: float = 1.0, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the dtypes of q, k, v. CPU tensors take the plain
    version; CUDA tensors launch the dQ kernel and the dK/dV kernel of width
    ``kernel_width(D)`` on the current stream, q, k, v, o and do zero-padded
    to it and the gradients sliced back (contiguous), or raise."""
    if _check_device(q, "masked_flash_attention_backward"):
        return masked_attention_backward_reference(
            q, k, v, q_lengths, m_lengths, o, m, s, do, scale, causal)
    _check_kernel_inputs(q, k, v, o, do)
    B, H, Tq, D = q.shape
    width = kernel_width(D)
    q, k, v, o, do = pad_head_width(width, q, k, v, o, do)
    for name, stat in (("m", m), ("s", s)):
        if (stat.shape != (B, H, Tq) or stat.dtype != torch.float32
                or stat.device != q.device or not stat.is_contiguous()):
            raise ValueError(f"{name} must be contiguous fp32 [{B}, {H}, {Tq}] "
                             f"on {q.device}")
    ql = _check_lengths(q_lengths, B, q.device, "q_lengths")
    ml = _check_lengths(m_lengths, B, q.device, "m_lengths")

    # the dQ kernel reads O and writes δ for the dK/dV kernel
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        launch_backward_kernel("dq", q, k, v, do, ql, ml, m, s, delta, (dq,),
                               scale, causal, o=o)
        launch_backward_kernel("dkv", q, k, v, do, ql, ml, m, s, delta,
                               (dk, dv), scale, causal)
    if width != D:
        dq, dk, dv = (g[..., :D].contiguous() for g in (dq, dk, dv))
    return dq, dk, dv


def kernel_name(kind: str, dtype: torch.dtype, head_dim: int = 64) -> str:
    """The kernel (its ``launch_counts`` key) that serves ``kind`` ("fwd",
    "dq" or "dkv") for ``dtype`` at head width ``head_dim``: bf16 takes the
    tensor-core kernels, fp32 the fp32-FMA ones, each at ``kernel_width(
    head_dim)`` (the fp32 forward at D >= 128 on the 3xTF32 kernel, and
    above 256 the bf16 forward in slices of up to 512 columns, under the
    same keys); the D = 128 and D = 256 instantiations' keys end in
    ``_d128`` and ``_d256``, the wide kernels' (every width above 256) in
    ``_wide``."""
    base = "masked_attention_fwd" if kind == "fwd" else f"masked_attention_bwd_{kind}"
    if dtype == torch.bfloat16:
        base += "_tc"
    return base + WIDTH_SUFFIX.get(kernel_width(head_dim), WIDE_SUFFIX)


def c_function(name: str) -> str:
    """The C function of the kernel whose ``launch_counts`` key is ``name``:
    one function a kernel serves every width."""
    for suffix in (*WIDTH_SUFFIX.values(), WIDE_SUFFIX):
        if suffix and name.endswith(suffix):
            return name.removesuffix(suffix)
    return name


def _launch(name: str, tensors, B: int, H: int, Tq: int, Tk: int, D: int,
            scale: float, causal: bool) -> None:
    """Call the C function of kernel ``name`` on the current stream with
    the tensors' pointers (None for a missing length) and the shape; raise
    if the launch fails, else count it under ``name``."""
    from . import _build
    fn = getattr(_build.load_library(), c_function(name))
    err = fn(*(None if t is None else t.data_ptr() for t in tensors),
             B, H, Tq, Tk, D, float(scale), int(bool(causal)),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1


def launch_backward_kernel(kernel: str, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor,
                           q_lengths: Optional[torch.Tensor],
                           m_lengths: Optional[torch.Tensor], m: torch.Tensor,
                           s: torch.Tensor, delta: torch.Tensor,
                           outs: Tuple[torch.Tensor, ...], scale: float,
                           causal: bool, o: Optional[torch.Tensor] = None) -> None:
    """Launch one backward kernel, ``"dq"`` (writes ``outs = (dq,)``) or
    ``"dkv"`` (``outs = (dk, dv)``), the one ``kernel_name`` picks for q's
    dtype and width, on the current stream, and count it. The tensors are
    taken as ``masked_flash_attention_backward`` checks and pads them: CUDA,
    contiguous, D native (64, 128, 256 or a multiple of 128 above),
    lengths int32 or None, ``delta`` fp32
    [B, H, Tq]. A kernel of ``DELTA_FORMING_KERNELS`` reads ``o`` and
    writes ``delta``; every other one reads ``delta`` and is given no
    ``o``. Raise on a width that is not native, on a wrong ``o`` or if the
    launch fails."""
    B, H, Tq, D = q.shape
    if not is_native_width(D):
        raise ValueError(f"a backward kernel takes the native widths {KERNEL_HEAD_DIMS} and "
                         f"the multiples of {WIDE_STEP} above; got {D} "
                         f"(masked_flash_attention_backward pads it)")
    name = kernel_name(kernel, q.dtype, D)
    if (o is not None) != (name in DELTA_FORMING_KERNELS):
        raise ValueError(f"{name} reads o" if o is None else f"{name} takes no o")
    reads_o = () if o is None else (o,)
    _launch(name, (q, k, v, do, *reads_o, q_lengths, m_lengths, m, s, delta, *outs),
            B, H, Tq, k.shape[2], D, scale, causal)


class MaskedFlashAttention(torch.autograd.Function):
    """Differentiable masked attention, the counterpart of the JAX
    package's ``masked_flash_attention`` custom VJP: the forward saves
    (q, k, v, lengths, o, m, s) and the backward recomputes P from (m, s).
    ``apply(q, k, v, q_lengths, m_lengths, scale, causal)`` returns o."""

    @staticmethod
    def forward(ctx, q, k, v, q_lengths, m_lengths, scale, causal):
        o, m, s = masked_flash_attention(q, k, v, q_lengths, m_lengths,
                                         scale, causal)
        ctx.save_for_backward(q, k, v, q_lengths, m_lengths, o, m, s)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_lengths, m_lengths, o, m, s = ctx.saved_tensors
        dq, dk, dv = masked_flash_attention_backward(
            q, k, v, q_lengths, m_lengths, o, m, s, do.contiguous(),
            ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None, None
