"""The port stands alone: importing and running `repro_torch` loads no
JAX and no module of the reference package `repro`."""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.core import sanitize as port_sanitize  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]

_RUN = r"""
import json, sys
import numpy as np
from repro_torch.core import LustreCluster
from repro_torch.fsio import LustreClient
data = np.random.default_rng(3).integers(1, 256, 200000,
                                         dtype=np.uint8).tobytes()
c = LustreCluster(osts=4, mdses=1, clients=2, spare_osts=1,
                  device="cpu")
fs = LustreClient(c, 0).mount()
fh = fs.creat("/f", stripe_count=3, stripe_size=16384, pattern="raid5")
fs.write(fh, data, offset=0)
fs.close(fh)
for t in c.ost_targets:
    t.commit()
c.fail_node("ost1")
r = LustreClient(c, 1).mount()
f = r.open("/f")
assert r.read(f, len(data), offset=0) == data
assert c.stats.counters["lov.reconstruct_unit"] > 0
c.lctl("rebuild", "OST0001", c.spare_uuids[0])     # function-local imports
assert c.lctl("mon_snapshot")["cluster"]
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
"""


@pytest.fixture(autouse=True)
def _port_sanitizer_guard():
    before = len(port_sanitize.state.violations)
    yield
    new = port_sanitize.state.violations[before:]
    assert not new, "port sanitizer violations:\n" + "\n".join(
        v.render() for v in new)


def test_running_the_port_loads_no_jax_and_no_reference_module():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", _RUN], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b|from\s+(jax|jaxlib|repro)\b)",
    re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    [*(REPO / "src" / "repro_torch").rglob("*.py"), REPO / "chip_smoke.py"]))
def test_port_source_imports_no_jax_and_no_reference_module(path):
    text = (REPO / path).read_text()
    bad = [m.group(0).strip() for m in _FORBIDDEN.finditer(text)]
    assert not bad, f"{path}: {bad}"
