"""Memory budgets derived from the device, their -f overrides, the routing
they drive, and where the persistent compile cache lives."""

import os
import subprocess
import sys

import numpy as np
import pytest

import sibeliaz_tpu
from sibeliaz_tpu.utils import device as device_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeDevice:
    platform = "gpu"
    device_kind = "Fake GPU"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_memory_bytes_reads_bytes_limit():
    dev = _FakeDevice({"bytes_limit": 60 << 30, "bytes_in_use": 1})
    assert device_mod.device_memory_bytes(dev) == 60 << 30


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_device_memory_bytes_raises_without_limit(stats):
    with pytest.raises(RuntimeError, match="bytes_limit"):
        device_mod.device_memory_bytes(_FakeDevice(stats))


def test_device_memory_bytes_cpu_backend_is_fixed():
    import jax

    assert jax.devices()[0].platform == "cpu"
    assert device_mod.device_memory_bytes() == device_mod.CPU_BUDGET_BYTES


def test_graph_budget_from_device_and_override(monkeypatch):
    from sibeliaz_tpu.graph import construct

    monkeypatch.setattr(construct, "device_memory_bytes", lambda: 80 << 30)
    assert construct.graph_budget_bytes() == int(
        (80 << 30) * construct.GRAPH_BUDGET_FRACTION
    )
    assert construct.graph_budget_bytes(3 << 30) == 3 << 30


def test_poa_scratch_budget_from_device_and_override(monkeypatch):
    from sibeliaz_tpu.align import tpu_poa

    monkeypatch.setattr(device_mod, "device_memory_bytes", lambda: 60 << 30)
    derived = tpu_poa.scratch_budget_bytes()
    assert derived == int((60 << 30) * 2 / 3 / tpu_poa.POA_PLAN_FACTOR)
    # -f overrides the device, and a tiny -f keeps a usable floor
    assert tpu_poa.scratch_budget_bytes(6 << 30) < derived
    assert tpu_poa.scratch_budget_bytes(1 << 20) == 64 << 20


def _small_genomes():
    from sibeliaz_tpu.core import alphabet

    rng = np.random.default_rng(3)
    base = alphabet.decode(rng.integers(0, 4, size=5000).astype(np.uint8))
    mut = base.copy()
    for p in np.flatnonzero(rng.random(len(mut)) < 0.02):
        mut[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
    return [base, mut]


@pytest.mark.parametrize("k,per_pos_budget,streamed_expected", [
    (15, 4 * 36, False),  # budget well above the monolithic plan
    (15, 18, True),       # below it: the multi-round streamed path
    (15, 40, False),      # between the one- and two-limb plans...
    (33, 40, True),       # ...the wider two-limb plan streams
])
def test_build_junctions_routes_by_budget(monkeypatch, k, per_pos_budget,
                                          streamed_expected):
    from sibeliaz_tpu.graph import construct, streamed

    assert construct.MONOLITHIC_PEAK_BYTES_PER_POS == 36
    assert construct.MONOLITHIC_PEAK_BYTES_PER_POS_TWO_LIMB == 58
    seqs = _small_genomes()
    bucket = 1 << (sum(map(len, seqs)) + len(seqs) - 2).bit_length()
    budget = bucket * per_pos_budget
    calls = []
    resident = streamed.build_junctions_streamed_resident

    def spy(*a, **kw):
        calls.append(kw)
        return resident(*a, chunk_size=4096, **kw)  # small chunks: fast

    monkeypatch.setattr(streamed, "build_junctions_streamed_resident", spy)
    got = construct.build_junctions(seqs, k, hbm_budget_bytes=budget)
    assert bool(calls) == streamed_expected
    if streamed_expected:
        assert calls[0]["budget_bytes"] == budget
        assert calls[0]["n_rounds"] >= 2
    from sibeliaz_tpu.graph.oracle import enumerate_junctions

    for a, b in zip(got, enumerate_junctions(seqs, k)):
        assert np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids)


def test_streamed_budget_bounds_rounds_per_pass():
    """A budget that fits one round buffer per rescan (G = 1) still gives
    records bit-equal to the monolithic kernel."""
    from sibeliaz_tpu.graph import construct, streamed

    seqs = _small_genomes()
    got = streamed.build_junctions_streamed_resident(
        seqs, 15, chunk_size=1024, n_rounds=3, budget_bytes=1
    )
    want = construct.build_junctions(seqs, 15)
    for a, b in zip(got, want):
        assert np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids)


def test_compile_cache_dir_honours_env():
    assert sibeliaz_tpu.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}
    ) is None


def test_compile_cache_dir_default_is_in_checkout_and_ignored():
    path = sibeliaz_tpu.compile_cache_dir({})
    assert path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_config_in_fresh_process(tmp_path, env_dir):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c",
         "import sibeliaz_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
        check=True,
    ).stdout.strip().splitlines()[-1]
    want = str(tmp_path) if env_dir else os.path.join(REPO, ".jax_cache")
    assert out == want
