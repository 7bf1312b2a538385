"""Fused per-phase LCB device state machine (lcb/fused.py): exactness.

The fused engine traces the complete per-bundle protocol (vote -> walk ->
minRun/positivity/rewind transitions, blocksfinder.h:228-310) into one
lax.while_loop per phase dispatch.  These tests assert (a) per-bundle
best-instance snapshots identical to the oracle's Process across mixed
tier escalations, and (b) byte-identical GFF through the full phase/commit
protocol."""

import sys

sys.path.insert(0, "tests")

from sibeliaz_tpu import pipeline
from sibeliaz_tpu.config import Config
from sibeliaz_tpu.lcb.fused import process_phase_fused, run_fused
from sibeliaz_tpu.lcb.oracle import LcbEngine

from reference_oracle import random_related_genomes


def build(seed, **kwargs):
    seqs, names = random_related_genomes(seed, **kwargs)
    cfg = Config(k=15)
    table = pipeline.build_table(seqs, names, cfg)
    eng = LcbEngine(table, cfg.min_block_size, cfg.max_branch_size, cfg.flanking)
    return seqs, names, cfg, table, eng


def test_fused_phase_matches_oracle_process():
    _, _, _, table, eng = build(520, length=1200, mut=0.03, rearrange=True)
    bundles = eng.make_bundles()[:32]
    got = process_phase_fused(eng, bundles)
    for b, bundle in enumerate(bundles):
        expect = eng.process(bundle)
        g = [(i.c, i.s, i.fi, i.bi, i.fdist, i.bdist, i.cmp, i.ffin, i.bfin)
             for i in got[b]]
        e = [(i.c, i.s, i.fi, i.bi, i.fdist, i.bdist, i.cmp, i.ffin, i.bfin)
             for i in expect]
        assert g == e, f"bundle {b} ({bundle.vid},{bundle.ch})"


def test_fused_phase_sharded_over_mesh():
    """Lanes sharded over an 8-device mesh: bit-equal to the oracle (the
    multi-chip LCB exploration path; lanes never communicate, GSPMD only
    inserts collectives for the loop-condition scalars)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    _, _, _, table, eng = build(522, length=1200, mut=0.03, rearrange=True)
    mesh = Mesh(np.array(jax.devices()[:8]), ("lanes",))
    bundles = eng.make_bundles()[:32]
    got = process_phase_fused(eng, bundles, mesh=mesh)
    for b, bundle in enumerate(bundles):
        expect = eng.process(bundle)
        g = [(i.c, i.s, i.fi, i.bi, i.fdist, i.bdist, i.cmp, i.ffin, i.bfin)
             for i in got[b]]
        e = [(i.c, i.s, i.fi, i.bi, i.fdist, i.bdist, i.cmp, i.ffin, i.bfin)
             for i in expect]
        assert g == e, f"bundle {b} ({bundle.vid},{bundle.ch})"


def test_fused_full_gff_byte_equal():
    from sibeliaz_tpu.output import gff as gff_mod
    from sibeliaz_tpu.output import trim as trim_mod

    seqs, names = random_related_genomes(521, length=1200, mut=0.03,
                                         rearrange=True)
    cfg = Config(k=15)

    def run(fused):
        table = pipeline.build_table(seqs, names, cfg)
        eng = LcbEngine(table, cfg.min_block_size, cfg.max_branch_size,
                        cfg.flanking)
        raw = run_fused(eng) if fused else eng.run()
        chr_lengths = [len(s) for s in seqs]
        blocks, _ = trim_mod.trim_blocks(raw, chr_lengths, cfg.min_block_size)
        return gff_mod.render_gff(blocks, names, chr_lengths)

    assert run(True) == run(False)


def test_fused_chunking_independent(monkeypatch):
    """Dispatch chunking (VOTE_BUDGET) must not affect results — the
    per-lane protocol is independent, mirroring the reference's
    thread-count-independence guarantee (NEWS.md:46)."""
    from sibeliaz_tpu.lcb import fused as fused_mod

    _, _, _, table, eng = build(523, length=1000, mut=0.03)
    bundles = eng.make_bundles()[:24]
    want = process_phase_fused(eng, bundles)
    monkeypatch.setattr(fused_mod, "VOTE_BUDGET", 1 << 14)  # tiny chunks
    got = fused_mod.process_phase_fused(eng, bundles)

    def key(insts):
        return [(i.c, i.s, i.fi, i.bi) for i in insts]

    assert [key(x) for x in got] == [key(x) for x in want]


def test_fused_lane_chunk_env_independent(monkeypatch):
    """SZ_FUSED_LANE_CHUNK (debug cap on lanes per dispatch) must be
    result-invariant: lanes are independent, so a
    hard cap on lanes-per-dispatch only changes dispatch count."""
    _, _, _, table, eng = build(524, length=1000, mut=0.03)
    bundles = eng.make_bundles()[:24]
    want = process_phase_fused(eng, bundles)
    monkeypatch.setenv("SZ_FUSED_LANE_CHUNK", "8")
    got = process_phase_fused(eng, bundles)

    def key(insts):
        return [(i.c, i.s, i.fi, i.bi) for i in insts]

    assert [key(x) for x in got] == [key(x) for x in want]


def _gff_for(seqs, names, cfg, fused, mesh=None):
    from sibeliaz_tpu.lcb.fused import run_fused
    from sibeliaz_tpu.output import gff as gff_mod
    from sibeliaz_tpu.output import trim as trim_mod

    table = pipeline.build_table(seqs, names, cfg)
    eng = LcbEngine(table, cfg.min_block_size, cfg.max_branch_size,
                    cfg.flanking)
    raw = run_fused(eng, mesh=mesh) if fused else eng.run()
    chr_lengths = [len(s) for s in seqs]
    blocks, _ = trim_mod.trim_blocks(raw, chr_lengths, cfg.min_block_size)
    return gff_mod.render_gff(blocks, names, chr_lengths)


def test_fused_segment_boundary_stress(monkeypatch):
    """The round-4 segmented state machine's riskiest path: mid-walk carry
    registers and slab snapshots crossing DISPATCH boundaries
    (blocksfinder.h:228-310 is the protocol being segmented).  Force tiny
    segments (SZ_FUSED_SEG=4) and tiny walk chunks (SZ_FUSED_WALK_CHUNK=2)
    so walks span many outer steps AND many dispatches, and assert (a) the
    GFF stays byte-identical to the host oracle, (b) the segment-dispatch
    count actually rose versus the default config — proof the boundaries
    were crossed, not merely configured."""
    import jax

    from sibeliaz_tpu.lcb import fused as fused_mod

    seqs, names = random_related_genomes(521, length=1200, mut=0.03,
                                         rearrange=True)
    cfg = Config(k=15)
    want = _gff_for(seqs, names, cfg, fused=False)

    results = {}
    for seg, walk in ((32, 16), (4, 2)):
        monkeypatch.setattr(fused_mod, "SEG_STEPS", seg)
        monkeypatch.setattr(fused_mod, "WALK_CHUNK", walk)
        monkeypatch.setattr(fused_mod, "_SEG_MAX", seg)  # no adaptive growth
        jax.clear_caches()  # WALK_CHUNK is a trace-time constant
        fused_mod._seg_counter["segments"] = 0
        got = _gff_for(seqs, names, cfg, fused=True)
        assert got == want, f"GFF diverged at seg={seg} walk={walk}"
        results[(seg, walk)] = fused_mod._seg_counter["segments"]
    assert results[(4, 2)] > results[(32, 16)], (
        f"tiny segments did not increase dispatch count: {results}"
    )
    assert results[(4, 2)] >= 4, (
        f"stress config crossed too few boundaries: {results}"
    )


def test_fused_segment_boundary_stress_mesh(monkeypatch):
    """Same boundary stress with lanes sharded over an 8-device mesh: the
    device-resident carry must survive dispatch boundaries under GSPMD
    partitioning too."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from sibeliaz_tpu.lcb import fused as fused_mod

    seqs, names = random_related_genomes(522, length=1200, mut=0.03,
                                         rearrange=True)
    cfg = Config(k=15)
    want = _gff_for(seqs, names, cfg, fused=False)
    mesh = Mesh(np.array(jax.devices()[:8]), ("lanes",))
    monkeypatch.setattr(fused_mod, "SEG_STEPS", 4)
    monkeypatch.setattr(fused_mod, "WALK_CHUNK", 2)
    monkeypatch.setattr(fused_mod, "_SEG_MAX", 4)
    jax.clear_caches()
    fused_mod._seg_counter["segments"] = 0
    got = _gff_for(seqs, names, cfg, fused=True, mesh=mesh)
    assert got == want
    assert fused_mod._seg_counter["segments"] >= 4


def test_fused_lane_compaction_exact(monkeypatch):
    """Active-lane compaction (round 5) is a pure permutation of
    independent lanes: forcing aggressive compaction (tiny floor) must
    leave the GFF byte-identical and must actually compact."""
    from sibeliaz_tpu.lcb import fused as fused_mod

    seqs, names = random_related_genomes(521, length=1200, mut=0.03,
                                         rearrange=True)
    cfg = Config(k=15)
    want = _gff_for(seqs, names, cfg, fused=False)
    monkeypatch.setenv("SZ_FUSED_COMPACT_MIN", "8")
    # tiny segments so the phase's drain tail spans many dispatches (the
    # production trigger is the measured 130-steps-on-9-lanes tail)
    monkeypatch.setattr(fused_mod, "SEG_STEPS", 4)
    monkeypatch.setattr(fused_mod, "_SEG_MAX", 4)
    fused_mod._seg_counter["compactions"] = 0
    got = _gff_for(seqs, names, cfg, fused=True)
    assert got == want
    assert fused_mod._seg_counter["compactions"] > 0, (
        "compaction never engaged under the forced tiny floor"
    )

    monkeypatch.setenv("SZ_FUSED_COMPACT", "0")
    fused_mod._seg_counter["compactions"] = 0
    got_off = _gff_for(seqs, names, cfg, fused=True)
    assert got_off == want
    assert fused_mod._seg_counter["compactions"] == 0
