"""Ring self-attention: sequence parallelism over the mesh's model axis (the
port of ``vaenar_tts_tpu/parallel/ring_attention.py``).

The JAX package shards the time axis of q, k and v over a mesh axis inside
``shard_map`` and rotates the k/v blocks with ``ppermute``. Here the model
group's processes (``parallel/distributed.py``) hold q, k and v whole, as
everything outside the ring is replicated in a model group:

* the split takes this process's time block of each (its backward gathers
  the blocks' gradients whole);
* the ring is plain torch ops, as JAX's is jnp: an online softmax over the
  key/value blocks in fp32 whatever the compute dtype, the finite mask
  value ``NEG`` of the attention kernels over invalid queries, invalid keys
  and the causal band, a running max that starts at ``NEG`` (not -inf, so
  a fully masked row comes out uniform over all T keys), n - 1 shifts of
  the k and v blocks one process on (``DistContext.model_shift``, whose
  backward shifts the gradients back), the last block accumulated without
  a send, and o / max(s, 1e-30) cast back to q's dtype;
* the gather concatenates the output blocks over time (its backward cuts
  the gradient to this process's block).

``ring_eligible`` is the JAX package's static check, and
``SequenceParallel`` carries it down the model (``VAENAR(seq_mesh=)``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.flash_attention import NEG
from .mesh import Mesh, gather_model, shift_model, split_model

# the shortest sequence the ring takes by default (``train.ring_min_seq``
# sets it per model): below it the collectives cost more than one local
# attention (the JAX package's analytical default; not measured on the card)
RING_MIN_SEQ = 1024


def ring_eligible(mesh: Optional[Mesh], axis: str, tq: int, tk: int,
                  min_seq: Optional[int] = None) -> bool:
    """Can and should this self-attention ring: a mesh whose ``axis`` has
    more than one process, equal query and key lengths that divide by it,
    and at least ``min_seq`` (``RING_MIN_SEQ`` by default)."""
    if mesh is None or axis not in mesh.shape:
        return False
    n = mesh.shape[axis]
    min_seq = RING_MIN_SEQ if min_seq is None else min_seq
    return n > 1 and tq == tk and tq % n == 0 and tq >= min_seq


def _local_ring(q, k, v, lengths, dist, scale: float, causal: bool) -> torch.Tensor:
    """``_local_ring_attention`` of the JAX package on this process's
    blocks [B, H, Tl, D]; lengths [B] of the whole sequence."""
    n, idx = dist.model_count, dist.model_index
    B, H, Tl, D = q.shape
    q32 = q.float()
    steps = torch.arange(Tl, device=q.device)
    q_pos = idx * Tl + steps  # the global positions of this block's queries
    lengths = lengths.to(q.device)[:, None]
    q_valid = (q_pos[None, :] < lengths)[:, None, :, None]  # [B, 1, Tl, 1]
    m = torch.full((B, H, Tl), NEG, dtype=torch.float32, device=q.device)
    s = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, H, Tl, D), dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for i in range(n):
        # the block held at step i started at process (idx - i) mod n
        k_pos = ((idx - i) % n) * Tl + steps
        logits = torch.matmul(q32, kb.float().transpose(-1, -2)) * scale
        mask = (k_pos[None, :] < lengths)[:, None, None, :] & q_valid
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        logits = torch.where(mask, logits, NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)  # rescales the accumulators so far
        p = torch.exp(logits - m_new[..., None])
        s = s * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.matmul(p, vb.float())
        m = m_new
        if i < n - 1:  # the last block needs no onward shift
            kb, vb = shift_model(kb, dist), shift_model(vb, dist)
    return (o / torch.clamp(s, min=1e-30)[..., None]).to(q.dtype)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor, dist, scale: float = 1.0,
                        causal: bool = False, axis: str = "model") -> torch.Tensor:
    """Masked self-attention [B, H, T, D] -> [B, H, T, D] with the time axis
    split over ``dist``'s model group (``axis`` must be "model": the port's
    mesh has no other group to ring over). q, k and v are whole and equal
    on every process of the group, T divides by its size; lengths [B]
    masks both queries and keys. Differentiable; the result is whole on
    every process."""
    if axis != "model":
        raise ValueError(f"the ring runs over the mesh's model axis, not {axis!r}")
    n = dist.model_count
    if q.shape[2] % n:
        raise ValueError(f"sequence length {q.shape[2]} does not divide over {n} processes")
    blocks = [split_model(x, dist, 2) for x in (q, k, v)]
    return gather_model(_local_ring(*blocks, lengths, dist, scale, causal), dist, 2)


@dataclasses.dataclass(frozen=True, eq=False)
class SequenceParallel:
    """Where a model's self-attentions ring: over ``dist``'s mesh axis
    ``axis``, from ``min_seq`` on (None: ``RING_MIN_SEQ``)."""
    dist: object
    axis: str = "model"
    min_seq: Optional[int] = None

    def eligible(self, tq: int, tk: int) -> bool:
        return ring_eligible(self.dist.mesh, self.axis, tq, tk, self.min_seq)


__all__ = ["RING_MIN_SEQ", "SequenceParallel", "ring_eligible", "ring_self_attention"]
