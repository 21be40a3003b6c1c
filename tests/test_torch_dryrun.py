"""The port's multi-process dry run (``python -m
salt_tpu_torch.parallel.dryrun N``, the counterpart of
``salt_tpu/parallel/dryrun.py``) at N = 2 and N = 4 gloo processes on
the CPU: it prints a line for each of its checks (the data-parallel
train step, the TTA predict over the group, the fold-parallel step, and
at 4 the hybrid fold x data step) and exits 0."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_prints_its_lines_and_exits_0(n):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "salt_tpu_torch.parallel.dryrun", str(n)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("dryrun")]
    want = [f"dryrun_multichip({n}) ok", "dryrun predict (TTA over the "
            "mesh) ok", "dryrun fold-parallel ok"]
    if n >= 4:
        want.append("dryrun hybrid fold x data ok")
    assert len(lines) == len(want), proc.stdout
    for line, start in zip(lines, want):
        assert line.startswith(start), line
    assert f"mesh=({n} ranks, gloo)" in lines[0]
    if n >= 4:
        assert "'fold': 2, 'data': 2" in lines[-1]
