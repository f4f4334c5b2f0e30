"""Drift test: the port's pure-Python modules are copies of the reference.

The simulator under `repro.core` / `repro.fsio`, its tools
(`tools/monitor.py`, `tools/audit.py`, `tools/lint/`), the token
pipeline (`data/`), the model and run configurations
(`models/config.py`), the architecture table (`configs/`) and the cell
table (`launch/cells.py`) hold no JAX and no kernel, so
`repro_torch` keeps its own copy of every such module its paths reach
instead of importing the reference (importing any `repro` module from
the port is forbidden).  A copy equals its reference source after
`port_source`, which

  * renames the package (`repro.` -> `repro_torch.`), and
  * drops the change-history tags of the reference comments
    ("(ISSUE-8)", "(PR 4)", ...), which say nothing about the code.

The lint's replay-idempotence matrix, `tests/replay_matrix.py`, is
copied the same way to `src/repro_torch/tests/replay_matrix.py`, where
the analyzer looks for it beside a scanned tree.

Allowed to differ, and therefore not listed in COPIED:

  * `core/lov.py` - the raid5 paths call the port's
    `repro_torch.kernels.ops` with the LOV's explicit `device`
    (`Lov(..., device=)`), and its docstrings name the CUDA kernel;
  * `core/cluster.py` - `LustreCluster(..., device="cuda")` checks the
    device up front and hands it to every LOV through `make_lov`;
  * `tools/lint/analyzer.py` - the analyzer finds the modules it checks,
    and names them in its findings and inventory, by path markers; the
    port's copy marks `repro_torch/core/`, `repro_torch/fsio/` and
    `src/repro_torch/` where the reference marks `repro/core/`,
    `repro/fsio/` and `src/repro/`, and differs by nothing else
    (`test_lint_analyzer_differs_only_by_path_markers`);
  * `tools/lint/fail_sites.json` - the OBD_FAIL site inventory, generated
    from the port's tree by `python -m repro_torch.tools.lint
    src/repro_torch --write-inventory` (tests/test_torch_lint.py holds it
    to what the analyzer regenerates);
  * `models/layers.py`, `models/transformer.py`, `models/registry.py` -
    written anew in PyTorch: parameters are nested dicts of tensors from a
    torch.Generator, the layer scan is a loop, the decode cache is written
    in place, the flash path calls the port's kernel, the sharding
    constraints (identity without a mesh) are dropped, and MoE,
    encoder-decoder, patch-prefix, windowed-cache decode and the rwkv6 /
    zamba2 families raise NotImplementedError;
  * `models/convert.py` - the numpy bridge for parameter trees and whole
    trainer states (the reference has no such module);
  * `train/steps.py`, `train/serve.py` - the train, prefill and serve
    steps as plain callables on an explicit device (no StepBundle, no
    shardings, no jit: the train step takes gradients with
    torch.autograd, remat is torch.utils.checkpoint), and a server with
    a `device` argument;
  * `ckpt/` - written anew: the reference imports `repro.kernels.ops`,
    and with it JAX, at module top; the port's manager computes parity
    with the port's kernel on an explicit `device`, takes torch tensors
    as leaves (bfloat16 by its raw bytes), restores bfloat16 leaves as
    tensors, and rebuilds a lost stripe of a large leaf from BRW-sized
    reads (the reference's one-RPC reads time out there: ROADMAP R9);
  * `optim/` - AdamW written anew in PyTorch (the reference is JAX):
    the same arithmetic, updating parameters and moments in place;
  * `train/trainer.py` - written anew: no mesh and no jit, a
    torch.Generator for the initial state, tensors on an explicit device,
    and `resume` rebuilds the state from the manifest's leaves;
  * `kernels/` - hand-written CUDA kernels beside their plain versions.
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
    "core/cobd.py", "core/snapshot.py", "core/chaos.py", "core/__init__.py",
    "tools/monitor.py", "tools/audit.py",
    "tools/lint/__init__.py", "tools/lint/__main__.py",
    "tools/lint/baseline.json",
    "fsio/client.py", "fsio/namespace.py", "fsio/__init__.py",
    "launch/cells.py",
    "data/__init__.py", "data/pipeline.py",
    "models/config.py",
    "configs/__init__.py",
    *sorted(f"configs/{p.name}" for p in (SRC / "repro" / "configs").glob(
        "*.py") if p.name != "__init__.py"),
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


def lint_markers(text: str) -> str:
    """The lint analyzer's path markers, reference -> port."""
    return re.sub(r'"(src/)?repro/', r'"\1repro_torch/', text)


def test_lint_analyzer_differs_only_by_path_markers():
    rel = "tools/lint/analyzer.py"
    ref = port_source((SRC / "repro" / rel).read_text())
    port = (SRC / "repro_torch" / rel).read_text()
    assert port != ref                     # the markers were rewritten
    assert port == lint_markers(ref), (
        f"src/repro_torch/{rel} differs from src/repro/{rel} by more than "
        "its path markers")


def test_replay_matrix_matches_reference():
    ref = (SRC.parent / "tests" / "replay_matrix.py").read_text()
    port = (SRC / "repro_torch" / "tests" / "replay_matrix.py").read_text()
    assert port == port_source(ref)
