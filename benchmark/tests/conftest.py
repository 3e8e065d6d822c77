import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.tests import tiny  # noqa: E402


@pytest.fixture
def root(tmp_path):
    return tiny.make_root(str(tmp_path))


@pytest.fixture
def run_cell(root, capsys):
    """Run the harness on a tiny cell here (the look for a card skipped);
    returns (exit code, result dict or None, standard error)."""
    from benchmark import run

    def go(cell, seed=4000000001, seconds=3, trace=0, extra=(), at=None):
        rc = run.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace),
                       *extra], root=at or root, require_cuda=False)
        out, err = capsys.readouterr()
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        return rc, (json.loads(lines[-1]) if lines else None), err
    return go
