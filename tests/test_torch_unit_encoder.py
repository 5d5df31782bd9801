"""The native unit encoder (native/_engine.cpp encode_se_units /
encode_pe_units, through map/native_engine.py:encode_units) against the
JAX package's NumPy encoder (TpuNativeEngine._se_units_mat /
_pe_units_mat), byte for byte: the packed nibble rows, the unit lengths,
the units a read (pair) and the oversized mask, for single-end reads and
pairs, both conversion modes, random PBAT on and off, at lmax 128 and 160,
on reads of every length from 0 to lmax + 20 over ACGTN, lowercase and
IUPAC codes; the counts of rows with bases and of reads (mates) over
lmax; and ends of different read counts, which raise before the library
writes a row."""

import numpy as np
import pytest

# read bytes: bases, N, lowercase and IUPAC codes
ALPHABET = np.frombuffer(b"ACGTNacgtnRYKMSWBDHVrykmswbdhv", dtype=np.uint8)


def _reads(rng, n, lmax, tag):
    lens = rng.integers(0, lmax + 21, n)
    return [(f"{tag}{i}", bytes(rng.choice(ALPHABET, int(k))))
            for i, k in enumerate(lens)]


def _jax(lmax):
    """The JAX engine's encoder methods, on an engine with lmax alone."""
    from abismal_tpu.map.pipeline import TpuNativeEngine

    eng = TpuNativeEngine.__new__(TpuNativeEngine)
    eng.lmax = lmax
    return eng


def _port(lmax):
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine

    eng = TorchNativeEngine.__new__(TorchNativeEngine)
    eng.lmax = lmax
    return eng


def _same(got, want):
    names = ("pnib", "lens_u", "per", "oversized")
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("lmax", [128, 160])
@pytest.mark.parametrize("random_pbat", [False, True], ids=["dir", "rpbat"])
@pytest.mark.parametrize("a_rich", [False, True], ids=["t_rich", "a_rich"])
@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_native_units_equal_jax(paired, a_rich, random_pbat, lmax):
    from abismal_tpu_torch.map.native_engine import encode_units, seq_blob

    rng = np.random.default_rng(lmax * 8 + 4 * paired + 2 * a_rich
                                + random_pbat)
    r1 = _reads(rng, 300, lmax, "a")
    r2 = _reads(rng, 300, lmax, "b")
    # a pair with an empty mate and one with a single oversized mate
    r1[0] = ("a0", b"")
    r2[0] = ("b0", b"ACGTN" * 20)
    r1[1] = ("a1", b"acgtRYKM" * 12)
    r2[1] = ("b1", b"G" * (lmax + 1))
    jax, port = _jax(lmax), _port(lmax)
    if paired:
        want = jax._pe_units_mat(r1, r2, a_rich, random_pbat)
        got = port._pe_units_mat(r1, r2, a_rich, random_pbat)
        seqs = (seq_blob(r1), seq_blob(r2))
        n_long = sum(len(s) > lmax for r in (r1, r2) for _, s in r)
    else:
        want = jax._se_units_mat(r1, a_rich, random_pbat)
        got = port._se_units_mat(r1, a_rich, random_pbat)
        seqs = (seq_blob(r1),)
        n_long = sum(len(s) > lmax for _, s in r1)
    _same(got, want)
    assert want[3].any() and not want[3].all()
    out = encode_units(lmax, seqs, a_rich, random_pbat)
    _same(out[:4], want)
    # the rows with bases: the JAX rows of non-zero length
    assert out[4] == int((want[1] > 0).sum())
    assert 0 < out[4] < want[2] * len(r1)
    assert out[5] == n_long > 0


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_empty_batch(paired):
    """A batch of 0 reads: one zero block of rows, as JAX lays it out.
    Single-end, the JAX encoder's own result; its PE encoder raises on an
    empty batch, so pairs are held to that layout: zero lengths for the
    block, no oversized pair."""
    from abismal_tpu_torch.map.native_engine import encode_units, seq_blob

    port = _port(128)
    if paired:
        got = port._pe_units_mat([], [], False, False)
        want = (np.zeros((4, 80), np.uint8), np.zeros(4, np.int32), 4,
                np.zeros(0, bool))
        seqs = (seq_blob([]), seq_blob([]))
    else:
        got = port._se_units_mat([], False, False)
        want = _jax(128)._se_units_mat([], False, False)
        seqs = (seq_blob([]),)
    _same(got, want)
    assert encode_units(128, seqs, False, False)[4:] == (0, 0)


def test_pair_sizes_differ():
    """Ends of different read counts (a mate file cut short) raise the
    engine's paired-end message, and the library's entry refuses them on
    its own (-1), writing nothing."""
    from abismal_tpu_torch.map.native_engine import (
        _ptr, encode_units, seq_blob,
    )
    from abismal_tpu_torch.native import get_engine_lib

    r1 = [(f"a{i}", b"ACGT" * 25) for i in range(6)]
    seqs = (seq_blob(r1), seq_blob(r1[:4]))
    with pytest.raises(RuntimeError, match="same number of reads"):
        encode_units(128, seqs, False, False)
    pnib = np.zeros((4 * 6, 80), np.uint8)
    lens, oversized = np.zeros(4 * 6, np.int32), np.zeros(6, bool)
    counts = np.zeros(2, np.int64)
    (b1, o1), (b2, o2) = seqs
    rc = get_engine_lib().encode_pe_units(
        _ptr(b1), _ptr(o1), 6, _ptr(b2), _ptr(o2), 4, 0, 0, 128, 80,
        _ptr(pnib), _ptr(lens), _ptr(oversized), _ptr(counts))
    assert rc == -1
    assert not (pnib.any() or lens.any() or oversized.any() or counts.any())
