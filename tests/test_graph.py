"""Graph-construction stage: oracle sanity + device implementation parity."""

import numpy as np
import pytest

from sibeliaz_tpu.core import alphabet
from sibeliaz_tpu.graph import construct, oracle


def s(x):
    return alphabet.str_to_seq(x)


def random_genomes(rng, n_chr, lo, hi, n_prob=0.0):
    seqs = []
    for _ in range(n_chr):
        L = int(rng.integers(lo, hi))
        codes = rng.integers(0, 4, size=L).astype(np.uint8)
        seq = alphabet.decode(codes)
        if n_prob:
            mask = rng.random(L) < n_prob
            seq[mask] = ord("N")
        seqs.append(seq)
    return seqs


def mutate(rng, seq, rate):
    seq = seq.copy()
    pos = np.flatnonzero(rng.random(len(seq)) < rate)
    for p in pos:
        seq[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
    return seq


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x.pos, y.pos), (x.pos, y.pos)
        assert np.array_equal(x.ids, y.ids), (x.ids, y.ids)


class TestOracle:
    def test_single_sequence_ends_are_junctions(self):
        # One chromosome, no repeats: only the two end k-mers are junctions.
        seq = s("ACGTAGGCTCA")
        recs = oracle.enumerate_junctions([seq], 5)
        assert list(recs[0].pos) == [0, len(seq) - 5]
        assert len(set(np.abs(recs[0].ids))) == 2

    def test_branch_is_junction(self):
        # Two chromosomes share a k-mer with different successors -> junction.
        a = s("AACCGGT" + "TTACGTA")
        b = s("AACCGGT" + "CCATGCC")
        k = 7
        recs = oracle.enumerate_junctions([a, b], k)
        # the shared first k-mer AACCGGT occurs at pos 0 of both with
        # different next chars => junction (also a run start).
        assert 0 in recs[0].pos and 0 in recs[1].pos
        id_a = recs[0].ids[list(recs[0].pos).index(0)]
        id_b = recs[1].ids[list(recs[1].pos).index(0)]
        assert id_a == id_b  # same vertex, same sign (same orientation)

    def test_rc_occurrence_gets_negative_sign(self):
        fwd = "AAACCCGGGTTTAAA"
        seq1 = s(fwd)
        seq2 = alphabet.reverse_complement(s(fwd))
        k = 5
        recs = oracle.enumerate_junctions([seq1, seq2], k)
        # For every vertex id on chr0 there must be the mirrored id on chr1.
        ids0 = set(recs[0].ids.tolist())
        ids1 = set(recs[1].ids.tolist())
        assert {-i for i in ids0} == ids1

    def test_n_breaks_runs(self):
        seq = s("ACGTACG" + "N" + "TTGCATG")
        recs = oracle.enumerate_junctions([seq], 5)
        # run1 valid positions 0..2, run2 valid positions 8..10
        assert 2 in recs[0].pos  # end of run 1
        assert 8 in recs[0].pos  # start of run 2
        assert not np.any((recs[0].pos > 2) & (recs[0].pos < 8))


class TestConstructParity:
    @pytest.mark.parametrize("seed,k,n_prob", [(0, 5, 0.0), (1, 7, 0.02),
                                               (2, 9, 0.0), (3, 15, 0.01),
                                               (4, 25, 0.0), (5, 3, 0.05)])
    def test_random_parity(self, seed, k, n_prob):
        rng = np.random.default_rng(seed)
        seqs = random_genomes(rng, 3, 50, 400, n_prob)
        assert_same(
            oracle.enumerate_junctions(seqs, k),
            construct.build_junctions(seqs, k),
        )

    def test_related_genomes_parity(self):
        # Mutated copies create realistic branching structure.
        rng = np.random.default_rng(7)
        base = random_genomes(rng, 2, 500, 800)[0]
        g1 = base
        g2 = mutate(rng, base, 0.01)
        g3 = alphabet.reverse_complement(mutate(rng, base, 0.005))
        k = 11
        assert_same(
            oracle.enumerate_junctions([g1, g2, g3], k),
            construct.build_junctions([g1, g2, g3], k),
        )

    def test_short_input(self):
        recs = construct.build_junctions([s("ACG")], 5)
        assert len(recs) == 1 and len(recs[0].pos) == 0

    def test_repeat_heavy_parity(self):
        rng = np.random.default_rng(11)
        unit = alphabet.decode(rng.integers(0, 4, size=40).astype(np.uint8))
        seq = np.concatenate([unit] * 6 + [alphabet.reverse_complement(unit)] * 2)
        assert_same(
            oracle.enumerate_junctions([seq], 9),
            construct.build_junctions([seq], 9),
        )


def test_v8_device_ids_match_v7_host_assignment():
    """v8 (on-device signed-id assignment) must reproduce v7 + the host
    unique/searchsorted id pass exactly, including N runs and both k."""
    import jax.numpy as jnp

    from sibeliaz_tpu.core import alphabet
    from sibeliaz_tpu.graph import construct

    rng = np.random.default_rng(5)
    for trial in range(4):
        n = int(rng.integers(2000, 20000))
        arr = alphabet.decode(rng.integers(0, 4, size=n).astype(np.uint8))
        for p in rng.integers(0, n, size=5):
            arr[p] = ord("N")
        codes = alphabet.encode(arr)
        bucket = max(4096, 1 << (len(codes) - 1).bit_length())
        codes = np.concatenate(
            [codes, np.full(bucket - len(codes), alphabet.BAD_CODE, np.uint8)]
        )
        k = [15, 25][trial % 2]
        cap = max(4096, bucket // 3)
        c7, p7, f7, fl7 = [
            np.asarray(x)
            for x in construct._junction_kernel_compact_v7(
                jnp.asarray(codes), k, cap
            )
        ]
        c8, p8, i8, d8, esc8 = [
            np.asarray(x)
            for x in construct._junction_kernel_compact_v8(
                jnp.asarray(codes), k, cap
            )
        ]
        c7, c8 = int(c7), int(c8)
        assert c7 == c8
        uniq = np.unique(f7[:c7])
        ids = np.searchsorted(uniq, f7[:c7]) + 1
        signed7 = np.where(fl7[:c7] & 1, ids, -ids)
        assert np.array_equal(p7[:c7], p8[:c8])
        assert np.array_equal(signed7, i8[:c8])
        # the uint16 delta stream must reconstruct the positions exactly
        assert int(esc8) == 0
        assert np.array_equal(
            np.cumsum(d8[:c8].astype(np.int64)), p8[:c8].astype(np.int64)
        )


def test_delta_escape_path_long_n_spacer():
    """A huge N spacer forces a position delta far beyond the packed uint8
    delta stream; build_junctions must take the escape-sentinel path
    (gather the absolute positions for those rows) and match the oracle."""
    rng = np.random.default_rng(77)
    left = alphabet.decode(rng.integers(0, 4, size=3000).astype(np.uint8))
    right = alphabet.decode(rng.integers(0, 4, size=3000).astype(np.uint8))
    spacer = np.full(70_000, ord("N"), np.uint8)
    seq = np.concatenate([left, spacer, right])
    seqs = [seq, np.concatenate([left.copy(), right.copy()])]
    got = construct.build_junctions(seqs, 15)
    want = oracle.enumerate_junctions(seqs, 15)
    assert_same(want, got)


def test_delta_escape_path_many_moderate_gaps():
    """Sparse junctions with many gaps in the 255..65535 range: every such
    row takes the v9 escape sentinel (uint8 delta overflow) and the host
    reconstructs each from gathered absolute positions — including the
    leading gap before the first junction."""
    rng = np.random.default_rng(177)
    base = alphabet.decode(rng.integers(0, 4, size=8000).astype(np.uint8))
    mut = base.copy()
    for p in range(600, 8000, 600):  # SNPs ~600 bp apart -> >255-bp gaps
        mut[p] = alphabet.decode(np.uint8((alphabet.encode(
            base[p:p + 1])[0] + 1) % 4))
    seqs = [base, mut]
    got = construct.build_junctions(seqs, 15)
    want = oracle.enumerate_junctions(seqs, 15)
    assert_same(want, got)


class TestWideK:
    """31 < k <= 61: two-limb canonical codes (construct._doubling_codes2).

    The reference driver passes any odd k through to TwoPaCo (sibeliaz:145,
    sibeliaz.cpp:13-35 enforces odd only); one int64 2-bit code word caps a
    single-limb design at k=31, so wider k sorts on two base-2^62 limbs."""

    def _pair(self, seed=3, n=12000):
        rng = np.random.default_rng(seed)
        base = alphabet.decode(rng.integers(0, 4, size=n).astype(np.uint8))
        mut = base.copy()
        for p in np.flatnonzero(rng.random(len(mut)) < 0.02):
            mut[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
        mut[2000:3000] = alphabet.reverse_complement(mut[2000:3000])
        base[100:130] = ord("N")
        return [base, mut]

    @pytest.mark.parametrize("k", [33, 45, 61])
    def test_wide_k_vs_bruteforce(self, k):
        seqs = self._pair()
        got = construct.build_junctions(seqs, k)
        want = oracle.enumerate_junctions(seqs, k)
        assert_same(want, got)

    def test_limb_boundary_parity(self):
        """k=31 (last single-limb) and k=33 (first two-limb) on the same
        input both match the oracle — the limb split introduces no edge
        artifacts at the format boundary."""
        seqs = self._pair(seed=9, n=6000)
        for k in (31, 33):
            assert_same(
                oracle.enumerate_junctions(seqs, k),
                construct.build_junctions(seqs, k),
            )

    def test_streamed_carries_wide_k(self):
        # round-3: two-limb codes flow through the memory-bounded paths too
        # (full bit-equality coverage lives in test_streamed/test_sharded)
        from sibeliaz_tpu.graph import streamed

        seqs = self._pair(seed=4, n=4000)
        assert_same(
            construct.build_junctions(seqs, 33),
            streamed.build_junctions_streamed_resident(
                seqs, 33, chunk_size=2048, n_rounds=2
            ),
        )

    def test_config_accepts_wide_odd_k(self):
        from sibeliaz_tpu.config import Config

        assert Config(k=33).k == 33
        assert Config(k=61).k == 61
        with pytest.raises(ValueError):
            Config(k=63)
        with pytest.raises(ValueError):
            Config(k=34)


@pytest.mark.parametrize("k", [15, 25])
def test_v7_cores_identical(k):
    """The cummax (default) and associative-scan class-analysis cores must
    produce identical outputs; the non-default core is selected only via
    SZ_JUNCTION_CORE at import, so this is its standing regression cover."""
    import jax.numpy as jnp

    from sibeliaz_tpu.graph.construct import _CORES

    rng = np.random.default_rng(77)
    base = rng.integers(0, 4, size=6000).astype(np.uint8)
    mut = base.copy()
    idx = rng.random(len(mut)) < 0.01
    mut[idx] = rng.integers(0, 4, size=int(idx.sum())).astype(np.uint8)
    codes = np.concatenate(
        [base, np.full(1, alphabet.BAD_CODE, np.uint8), mut]
    )
    outs = {name: fn(jnp.asarray(codes), k) for name, fn in _CORES.items()}
    ref = outs.pop("cummax")
    names = ["junction", "first", "idx", "packed", "seg_start"]
    for other, got in outs.items():
        for name, x, y in zip(names, ref, got):
            assert np.array_equal(np.asarray(x), np.asarray(y)), (
                other, name,
            )
