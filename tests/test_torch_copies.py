"""Drift test: the port's simulator modules are copies of the reference.

The simulator under `repro.core` / `repro.fsio` holds no JAX and no
kernel, so `repro_torch` keeps its own copy of every module its raid5
data path reaches instead of importing the reference (importing any
`repro` module from the port is forbidden).  A copy equals its reference
source after `port_source`, which

  * renames the package (`repro.` -> `repro_torch.`), and
  * drops the change-history tags of the reference comments
    ("(ISSUE-8)", "(PR 4)", ...), which say nothing about the code.

Allowed to differ, and therefore not listed in COPIED:

  * `core/lov.py` - the raid5 paths call the port's
    `repro_torch.kernels.ops` with the LOV's explicit `device`
    (`Lov(..., device=)`), and its docstrings name the CUDA kernel;
  * `core/cluster.py` - `LustreCluster(..., device="cuda")` checks the
    device up front and hands it to every LOV through `make_lov`;
  * `core/__init__.py`, `fsio/__init__.py` - export only what the port
    has (`fsio.namespace` is not ported yet).
"""
import pathlib
import re

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

COPIED = [
    "core/sim.py", "core/metrics.py", "core/fail.py", "core/sanitize.py",
    "core/portals.py", "core/nrs.py", "core/ptlrpc.py",
    "core/llog.py", "core/changelog.py", "core/dlm.py", "core/recovery.py",
    "core/obd.py", "core/ost.py", "core/osc.py",
    "core/mds.py", "core/mdc.py",
    "tools/monitor.py",
    "fsio/client.py",
]

_HISTORY_TAGS = [
    (re.compile(r" ?\(§?(?:ISSUE-|PR )\d+[^)]*\)"), ""),
    (re.compile(r",? §ISSUE-\d+"), ""),
    (re.compile(r"\b(?:ISSUE-|PR )\d+ "), ""),
]


def port_source(text: str) -> str:
    """Reference module source -> the port's copy of it."""
    text = re.sub(r"\brepro\.", "repro_torch.", text)
    for pat, rep in _HISTORY_TAGS:
        text = pat.sub(rep, text)
    return text


@pytest.mark.parametrize("rel", COPIED)
def test_copy_matches_reference(rel):
    ref = (SRC / "repro" / rel).read_text()
    port = (SRC / "repro_torch" / rel).read_text()
    assert port == port_source(ref), (
        f"src/repro_torch/{rel} drifted from src/repro/{rel}; "
        "re-copy it through port_source()")


@pytest.mark.parametrize("rel", COPIED)
def test_copy_has_no_reference_import_or_history_tag(rel):
    port = (SRC / "repro_torch" / rel).read_text()
    assert not re.search(r"\b(from|import) repro\b", port)
    assert not re.search(r"ISSUE-\d|\bPR \d", port)
