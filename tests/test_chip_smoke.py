"""chip_smoke.py and bench.py refuse to run without a GPU, and the smoke
run's MAF comparison ignores nothing but the `# cmd=` line.  The GPU
phases themselves run only on the card (python chip_smoke.py)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

MAF = (
    b"##maf version=1\n"
    b"# sibeliaz v1.2.7 \n"
    b"# cmd=-k 15 -o out a.fa b.fa\n"
    b"\na\n"
    b"s g1.chr1 0 8 + 100 ACGTACGT\n"
    b"s g2.chr1 4 8 - 100 ACGTAC-T\n"
)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_exits_nonzero_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, script], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert proc.stdout.strip() == ""


def test_maf_compare_ignores_cmd_line():
    other = MAF.replace(b"# cmd=-k 15 -o out a.fa b.fa",
                        b"# cmd=-k 15 --align-engine tpu -o o2 a.fa b.fa")
    assert other != MAF
    assert chip_smoke.strip_maf_cmd(other) == chip_smoke.strip_maf_cmd(MAF)


@pytest.mark.parametrize("old,new", [
    (b"# sibeliaz v1.2.7 \n", b"# sibeliaz v1.2.8 \n"),  # other header
    (b"ACGTAC-T", b"ACGTACGT"),                           # alignment row
    (b"\na\n", b"\n\na\n"),                               # layout
    (b"##maf version=1\n", b"##maf version=2\n"),         # first line
])
def test_maf_compare_keeps_every_other_byte(old, new):
    changed = MAF.replace(old, new, 1)
    assert changed != MAF
    assert chip_smoke.strip_maf_cmd(changed) != chip_smoke.strip_maf_cmd(MAF)


def test_maf_compare_keeps_cmd_text_inside_rows():
    changed = MAF.replace(b"s g2.chr1", b"s # cmd=g2", 1)
    assert chip_smoke.strip_maf_cmd(changed) != chip_smoke.strip_maf_cmd(MAF)
