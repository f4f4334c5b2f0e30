"""The port stands alone: importing and running `repro_torch` (the raid5
data path, a flash prefill, the batched server, a checkpoint save and
restore and a Trainer's train step) loads no JAX and no module of the
reference package `repro`."""
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
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers, registry
from repro_torch.models.config import RunConfig
from repro_torch.train.serve import BatchedServer, Request
from repro_torch.train.steps import build_prefill_step
cfg = get_smoke_config("qwen3-4b")
params = layers.tree_init(registry.param_defs(cfg),
                          torch.Generator().manual_seed(0))
rc = RunConfig(seq_len=32, global_batch=2, kind="prefill", attn_impl="flash")
tok, cache = build_prefill_step(cfg, rc, device="cpu")(
    params, {"tokens": np.ones((2, 32), np.int32)})
assert tuple(tok.shape) == (2, 1) and tuple(cache["k"].shape)[:3] == (2, 2, 32)
out = BatchedServer(cfg, params, max_seq=16, device="cpu").generate(
    [Request(1, [3, 4, 5], max_new=3), Request(2, [7], max_new=2)])
assert [len(r.out) for r in out] == [3, 2]
from repro_torch.ckpt import CheckpointManager
from repro_torch.train.trainer import Trainer, TrainerConfig
c = LustreCluster(osts=3, mdses=1, clients=1, device="cpu")
cm = CheckpointManager([LustreClient(c, 0).mount()], base="/ck",
                       stripe_count=3, stripe_size=4096, parity=True)
cm.save(1, {"w": torch.ones(3000), "step": torch.tensor(1, dtype=torch.int32)})
assert cm.restore(1)[0]["w"].sum() == 3000
tr = Trainer(c, TrainerConfig(
    model=cfg, rc=RunConfig(seq_len=16, global_batch=2, kind="train",
                            attn_impl="ref"),
    ckpt_every=1, dataset_seqs=8, n_writers=1, parity=True))
assert tr.run(1)[0]["step"] == 1 and tr.ckpt.steps() == [1]
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
    [*(REPO / "src" / "repro_torch").rglob("*.py"), REPO / "chip_smoke.py",
     REPO / "profile_model.py"]))
def test_port_source_imports_no_jax_and_no_reference_module(path):
    text = (REPO / path).read_text()
    bad = [m.group(0).strip() for m in _FORBIDDEN.finditer(text)]
    assert not bad, f"{path}: {bad}"
