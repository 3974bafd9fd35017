"""chip_smoke.py refuses to run without a GPU: no result line, non-zero
exit."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def test_device_check_fails_on_cpu():
    sys.path.insert(0, ROOT)
    import chip_smoke

    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu()

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    lines = r.stdout.strip().splitlines()
    if lines:
        with pytest.raises(ValueError):
            json.loads(lines[-1])
