"""K1's least time on the card, counted from the arguments a chunk hands
it: the yardstick of k1_roofline.  Frozen copies, so that a change to the
program cannot move it: k1_bound, chip_smoke.py:475-495; nbytes_of,
chip_smoke.py:371-372; 4 operations a word, chip_smoke.py:229."""

from __future__ import annotations

from .kernels import bound

OPS_PER_WORD_COMPARE = 4  # funnel shift, and, popc, accumulate


def nbytes_of(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def k1_bound(genome32, pos, pk, b_of, nw_of):
    """K1's bytes and operations for these inputs: the distinct genome
    words the windows touch (inside the genome), the index and result
    arrays once, the read words of the units named, 4 ops per word."""
    import torch

    n_gw, nw_words = genome32.shape[0], pk.shape[1]
    w = ((pos & 0xFFFFFFFF) >> 3)[:, None] + torch.arange(
        nw_words + 1, device=pos.device)[None, :]
    # the last word of a window matters only under a nibble shift
    need = nw_of.long() + ((pos & 7) != 0).long()
    used = torch.arange(nw_words + 1, device=pos.device)[None, :] \
        < need[:, None]
    touched = torch.zeros(n_gw + 1, dtype=torch.bool, device=pos.device)
    touched[torch.where(used & (w < n_gw), w, n_gw)] = True
    n_words = int(touched[:n_gw].sum().item())
    n_units = int(torch.unique(b_of).numel())
    G = pos.shape[0]
    nbytes = 4 * n_words + nbytes_of(pos, b_of, nw_of) + 4 * G \
        + 4 * nw_words * n_units
    return bound(nbytes, OPS_PER_WORD_COMPARE * int(nw_of.sum().item()))
