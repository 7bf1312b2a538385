"""Device-batched POA must produce exactly the spec's MSA."""

import numpy as np
import pytest

from sibeliaz_tpu.align import poa_ref, tpu_poa
from sibeliaz_tpu.core import alphabet


def s(x):
    return alphabet.str_to_seq(x)


def rand_block(rng, base_len, n_copies, mut=0.08, indel=True):
    base = alphabet.decode(rng.integers(0, 4, size=base_len).astype(np.uint8))
    seqs = [base]
    for _ in range(n_copies - 1):
        seq = base.copy()
        for p in np.flatnonzero(rng.random(len(seq)) < mut):
            seq[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
        if indel and rng.random() < 0.6:
            cut = int(rng.integers(0, len(seq) - 4))
            seq = np.delete(seq, slice(cut, cut + int(rng.integers(1, 4))))
        seqs.append(seq)
    return seqs


def test_simple_identical():
    got = tpu_poa.poa_msa_batch_tpu([[s("ACGTACGT")] * 3])
    assert got[0] == [b"ACGTACGT"] * 3


@pytest.mark.parametrize("seed", range(6))
def test_matches_spec(seed):
    rng = np.random.default_rng(seed)
    blocks = [
        rand_block(rng, int(rng.integers(20, 80)), int(rng.integers(2, 5)))
        for _ in range(3)
    ]
    expect = [poa_ref.poa_msa(b) for b in blocks]
    got = tpu_poa.poa_msa_batch_tpu(blocks)
    for e, g in zip(expect, got):
        assert g == e


def test_mixed_copy_counts():
    rng = np.random.default_rng(100)
    blocks = [
        rand_block(rng, 40, 2),
        rand_block(rng, 50, 5),
        rand_block(rng, 30, 3),
    ]
    expect = [poa_ref.poa_msa(b) for b in blocks]
    got = tpu_poa.poa_msa_batch_tpu(blocks)
    assert got == expect


def test_oversized_single_block_falls_back():
    """A block whose single-dispatch DP plan exceeds the HBM budget must
    return None (native fallback) instead of dispatching: its modeled
    9.4 GB of scratch exceeds the CPU backend's budget."""
    import numpy as np

    from sibeliaz_tpu.align import tpu_poa

    rng = np.random.default_rng(5)
    rows = [
        (rng.integers(0, 4, size=30_000).astype(np.uint8) + ord("A"))
        for _ in range(2)
    ]
    out = tpu_poa.poa_msa_batch_tpu([rows])
    assert out == [None]


# ---------------------------------------------------------------------------
# Certificate-exact banding (round 5): the banded device DP must be
# byte-identical to the spec — the certificate (align/native/poa.cpp's
# "exact banding" argument, ported to per-rank windows in tpu_poa) says
# banding may never change a single traceback decision.
# ---------------------------------------------------------------------------


def _stats():
    return dict(tpu_poa._STATS)


@pytest.mark.parametrize("seed", range(4))
def test_banded_matches_spec(seed, monkeypatch):
    """Band small blocks by forcing the band gate low; MSAs must equal the
    spec byte-for-byte and the banded path must actually run."""
    monkeypatch.setenv("SZ_POA_BAND_MIN", "16")
    rng = np.random.default_rng(200 + seed)
    blocks = [
        rand_block(rng, int(rng.integers(120, 400)), int(rng.integers(2, 6)),
                   mut=0.05)
        for _ in range(3)
    ]
    before = _stats()["banded_rounds"]
    expect = [poa_ref.poa_msa(b) for b in blocks]
    got = tpu_poa.poa_msa_batch_tpu(blocks)
    assert got == expect
    assert _stats()["banded_rounds"] > before, "banding gate never engaged"


def test_banded_pass2_certification(monkeypatch):
    """A divergent pair whose optimal score falls below the pass-1 slack
    guess must trigger the certified pass-2 re-band and still produce the
    spec's exact MSA."""
    monkeypatch.setenv("SZ_POA_BAND_MIN", "16")
    rng = np.random.default_rng(77)
    # unrelated sequences: achieved score way below sink_ub - slack
    a = alphabet.decode(rng.integers(0, 4, size=300).astype(np.uint8))
    b = alphabet.decode(rng.integers(0, 4, size=280).astype(np.uint8))
    before = _stats()["band_pass2"]
    expect = poa_ref.poa_msa([a, b])
    got = tpu_poa.poa_msa_batch_tpu([[a, b]])
    assert got == [expect]
    assert _stats()["band_pass2"] > before, (
        "expected an uncertified pass 1 on unrelated sequences"
    )


def test_banded_tie_heavy_low_complexity(monkeypatch):
    """Low-complexity repeats maximize DP ties; banding must resolve every
    tie exactly as the full DP does (equal operands in-band)."""
    monkeypatch.setenv("SZ_POA_BAND_MIN", "16")
    base = ("ACACACACAT" * 30)
    blocks = []
    rng = np.random.default_rng(9)
    seqs = [s(base)]
    for _ in range(3):
        q = np.array(seqs[0]).copy()
        cut = int(rng.integers(10, len(q) - 20))
        q = np.delete(q, slice(cut, cut + int(rng.integers(2, 12))))
        seqs.append(q)
    blocks.append(seqs)
    expect = [poa_ref.poa_msa(b) for b in blocks]
    got = tpu_poa.poa_msa_batch_tpu(blocks)
    assert got == expect


def test_banded_with_indels_long(monkeypatch):
    """Longer indel-rich blocks over the default band gate: exercises the
    production band path (no monkeypatched gate) end-to-end."""
    rng = np.random.default_rng(42)
    blocks = [rand_block(rng, 600, 4, mut=0.03)]
    before = _stats()["banded_rounds"]
    expect = [poa_ref.poa_msa(b) for b in blocks]
    got = tpu_poa.poa_msa_batch_tpu(blocks)
    assert got == expect
    assert _stats()["banded_rounds"] > before


def test_band_disable_env(monkeypatch):
    """SZ_POA_BAND=0 must force the unbanded path and identical output."""
    monkeypatch.setenv("SZ_POA_BAND", "0")
    rng = np.random.default_rng(1234)
    blocks = [rand_block(rng, 300, 3, mut=0.05)]
    before = _stats()["banded_rounds"]
    got = tpu_poa.poa_msa_batch_tpu(blocks)
    assert got == [poa_ref.poa_msa(blocks[0])]
    assert _stats()["banded_rounds"] == before


def test_depth_ranges_brute_force():
    """_depth_ranges' chain-run-compressed fills must equal the
    definitional per-node recurrences (the band certificate rests on
    these being exact bounds)."""
    rng = np.random.default_rng(0)
    g = poa_ref.PoaGraph()
    base = alphabet.decode(rng.integers(0, 4, size=150).astype(np.uint8))
    g.add_first(base)
    for _ in range(3):
        q = base.copy()
        for p in np.flatnonzero(rng.random(len(q)) < 0.06):
            q[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
        cut = int(rng.integers(5, len(q) - 10))
        q = np.delete(q, slice(cut, cut + 3))
        g.add_sequence(q)
    n_max = 512
    topo, nc, pi, po, sink = tpu_poa._extract_arrays(g, n_max)
    N = len(topo)
    mind, maxd, mins, maxs = tpu_poa._depth_ranges(pi, po, sink, N, n_max)
    BIG = 1 << 50
    bm = np.empty(N, np.int64)
    bM = np.empty(N, np.int64)
    for r in range(N):
        if po[r, 0] and pi[r, 0] == n_max:
            bm[r] = bM[r] = 1
        else:
            ps = pi[r][po[r]]
            bm[r] = bm[ps].min() + 1
            bM[r] = bM[ps].max() + 1
    sm = np.where(sink[:N], 0, BIG).astype(np.int64)
    sM = np.where(sink[:N], 0, -BIG).astype(np.int64)
    for r in range(N - 1, -1, -1):
        if not (po[r, 0] and pi[r, 0] == n_max):
            for p in pi[r][po[r]]:
                sm[p] = min(sm[p], sm[r] + 1)
                sM[p] = max(sM[p], sM[r] + 1)
    assert np.array_equal(mind, bm) and np.array_equal(maxd, bM)
    assert np.array_equal(mins, sm) and np.array_equal(maxs, sM)
