"""K5: the slot-rank carry of the fused programs, one warp a segment.

Replaces the JAX programs' scatter-max plus running max
(jax.lax.associative_scan(jnp.maximum, ...)) and the prefix counts around
it: abismal_tpu/map/pipeline.py:1296-1323 (single-end, the scan at
:1317-1320: each candidate's rank among its read's gated candidates) and
:1680-1697 (paired-end, the scan at :1694-1696: among its unit's accepted
candidates).  It is not a pl.pallas_call: the JAX programs leave it to
XLA.

For a mask gate (n,) and segments with starts seg_start (n_seg,),
non-decreasing, clamped to n, the first 0, and ends seg_end:
  - rank[i], i in [0, n): the gated entries in [seg_start[r*], i), r* the
    last segment with seg_start[r*] <= i;
  - counts[r]: the gated entries in [seg_start[r], seg_end[r]); with a
    second mask ex, also its entries there.
The kernel (csrc/segment_rank.cu) holds the programs' contract:
seg_start[r] <= seg_end[r] <= seg_start[r + 1], and gate and ex false past
the last segment's end (the programs gate on valid = f < total, and the
last span ends at min(total, n)); there the tail's rank is the last
segment's count.  Bound on the card: bytes, ~10 a candidate, far under a
launch; what made the old torch.cummax slow is that one block walked the
pool, so the kernel spreads segments and the tail over warps of the whole
card.  segment_rank_plain is the programs' former torch code, the
reference; segment_rank launches the kernel for CUDA tensors."""

from __future__ import annotations

import torch

from . import _build

I64 = torch.int64


def segment_rank_plain(gate, seg_start, seg_end, ex=None):
    """Plain PyTorch K5.  gate (n,) bool; seg_start, seg_end (n_seg,)
    int64; ex (n,) bool or None.  Returns (rank (n,), counts (n_seg,)),
    int64, and with ex also ex_counts (n_seg,): the gated prefix g_exc
    less its value at each candidate's segment start, carried forward by
    a scatter-max and a running max (segment bases never decrease)."""
    n = gate.shape[0]
    gt = gate.to(I64)
    g_inc = torch.cumsum(gt, dim=0)
    g_exc = g_inc - gt
    g_at = torch.cat([g_exc, g_inc[-1:]])
    counts = g_at[seg_end] - g_at[seg_start]
    base_of = torch.zeros(n + 1, dtype=I64, device=gate.device).scatter_reduce(
        0, seg_start, g_at[seg_start], "amax")
    rank = g_exc - torch.cummax(base_of[:n], dim=0).values
    if ex is None:
        return rank, counts
    ex_at = torch.cat([torch.zeros(1, dtype=I64, device=gate.device),
                       torch.cumsum(ex.to(I64), dim=0)])
    return rank, counts, ex_at[seg_end] - ex_at[seg_start]


def segment_rank(gate, seg_start, seg_end, ex=None):
    """K5 wrapper: the plain version for CPU tensors, for CUDA tensors the
    CUDA kernel (or an error), one launch that takes no host sync and
    allocates only its outputs.  Same arguments and result as
    segment_rank_plain."""
    if gate.device.type == "cpu":
        return segment_rank_plain(gate, seg_start, seg_end, ex)
    # the kernel counts mask bytes 16 at a time: 16-byte aligned masks
    masks = [_build.aligned(m.to(torch.bool).contiguous(), 16)
             for m in ((gate,) if ex is None else (gate, ex))]
    gate = masks[0]
    seg_start, seg_end = (t.to(I64).contiguous() for t in (seg_start,
                                                          seg_end))
    _build.require_device("segment_rank", *masks, seg_start, seg_end)
    n, n_seg = gate.shape[0], seg_start.shape[0]
    if (any(m.dim() != 1 or m.shape[0] != n for m in masks)
            or seg_start.dim() != 1 or seg_end.shape != seg_start.shape
            or n == 0 or n_seg == 0):
        raise ValueError("segment_rank: operand shapes disagree")
    n_out = 2 if ex is None else 3
    buf = torch.empty(n + (n_out - 1) * n_seg, dtype=I64, device=gate.device)
    outs = [buf[:n]] + [buf[n + k * n_seg : n + (k + 1) * n_seg]
                        for k in range(n_out - 1)]
    lib = _build.load()
    with torch.cuda.device(gate.device):
        rc = lib.segment_rank_launch(
            gate.data_ptr(), None if ex is None else masks[1].data_ptr(), n,
            seg_start.data_ptr(), seg_end.data_ptr(), n_seg,
            outs[0].data_ptr(), outs[1].data_ptr(),
            None if ex is None else outs[2].data_ptr(),
            _build.stream_of(gate))
    _build.check(rc, "segment_rank")
    segment_rank.launches += 1
    return tuple(outs)


segment_rank.launches = 0
