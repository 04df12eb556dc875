"""The port's examples (examples/torch/, the counterparts of the JAX
package's examples/01-06 at their sizes) run on the CPU, each in a process
of its own as a user runs it, and exit 0."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples" / "torch").glob("0*.py"))


def test_every_jax_example_has_a_port():
    names = [p.name for p in sorted((ROOT / "examples").glob("0*.py"))]
    assert [p.name for p in EXAMPLES] == names


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_runs_on_the_cpu(path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, str(path), "--device", "cpu"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip(), proc.stderr[-3000:]
