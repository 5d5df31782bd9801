"""K1: bisulfite-aware popcount Hamming compare (abismal.cpp full_compare).

Replaces abismal_tpu/kernels/popcount_compare.py:_body.  For every
candidate g of the global candidate list,

    d[g] = sum_{j < nw_of[g]} 8 - popcount32(pk_unit[b_of[g], j] & win[g, j])

where win[g, j] is the genome word run at word pos[g] >> 3 funnel-shifted
right by 4 * (pos[g] & 7) bits.  The CUDA kernel (csrc/popcount_compare.cu)
puts four lanes on a candidate and reads genome32 and the unit's packed
read words directly as aligned 128-bit loads; the TPU version's overlapped
genome rows, per-candidate megarow copy and word-alignment log-roll are
not needed on the GPU.  d is signed: an IUPAC genome nibble
ANDed with a read nibble can leave several bits set, so a word's popcount
can exceed 8 and d can go below zero (pipeline.py:1324-1329)."""

from __future__ import annotations

import torch

from . import _build

M32 = 0xFFFFFFFF


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 tensors carrying u32 values (torch has no
    popcount op)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def genome_words(genome32: torch.Tensor, widx: torch.Tensor) -> torch.Tensor:
    """u32 words of the packed genome (int32 storage) at int64 word indices,
    as int64; indices past the end read 0 (the TPU layout's guard rows)."""
    n = genome32.shape[0]
    w = genome32[widx.clamp(0, n - 1)].to(torch.int64) & M32
    return torch.where(widx < n, w, 0)


def popcount_compare_plain(genome32, pos, pk_unit, b_of, nw_of):
    """Plain PyTorch K1.  genome32 (NG,) int32 (u32 bits); pos (G,) int64
    u32 nibble positions; pk_unit (B, nw_words) int32 packed read words;
    b_of (G,) unit of each candidate; nw_of (G,) valid word count.
    Returns d (G,) int32."""
    nw_words = pk_unit.shape[1]
    p = pos.to(torch.int64) & M32
    ar = torch.arange(nw_words + 1, device=pos.device)
    words = genome_words(genome32, (p >> 3)[:, None] + ar[None, :])
    sh = ((p & 7) * 4)[:, None]
    win = ((words[:, :-1] >> sh) | (words[:, 1:] << (32 - sh))) & M32
    rw = pk_unit.to(torch.int64)[b_of.to(torch.int64)] & M32
    m = popcount32(rw & win)
    live = ar[None, :nw_words] < nw_of.to(torch.int64)[:, None]
    return torch.where(live, 8 - m, 0).sum(dim=1).to(torch.int32)


def popcount_compare(genome32, pos, pk_unit, b_of, nw_of):
    """K1 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (or an error).  Same arguments and result as
    popcount_compare_plain."""
    if pos.device.type == "cpu":
        return popcount_compare_plain(genome32, pos, pk_unit, b_of, nw_of)
    genome32 = _build.aligned(genome32.to(torch.int32).contiguous(), 16)
    pos = pos.to(torch.int64).contiguous()
    pk_unit = _build.aligned(pk_unit.to(torch.int32).contiguous(), 16)
    b_of = b_of.to(torch.int64).contiguous()
    nw_of = nw_of.to(torch.int32).contiguous()
    _build.require_device("popcount_compare", genome32, pos, pk_unit, b_of,
                          nw_of)
    G = pos.shape[0]
    d = torch.empty(G, dtype=torch.int32, device=pos.device)
    if G:
        lib = _build.load()
        # the runtime launches on the calling thread's current device
        with torch.cuda.device(pos.device):
            rc = lib.popcount_compare_launch(
                genome32.data_ptr(), genome32.shape[0], pos.data_ptr(),
                pk_unit.data_ptr(), pk_unit.shape[1], b_of.data_ptr(),
                nw_of.data_ptr(), d.data_ptr(), G, _build.stream_of(pos))
        _build.check(rc, "popcount_compare")
        popcount_compare.launches += 1
    return d


popcount_compare.launches = 0
