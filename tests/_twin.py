"""Twins of the reference's simulator suites, run on the port.

`tests/test_torch_twin_<name>.py` reads the reference suite
`tests/test_<name>.py` as text, rewrites it with `port_source` (from
tests/test_torch_copies.py: `repro.` -> `repro_torch.`), points its file
paths at the port's tree, and executes the result in the twin module's
own namespace (`load`), so pytest collects the reference's tests there
and runs them, unchanged, on the port: its forks `core/cluster.py` and
`core/lov.py` (parity through the port's kernels), its copies of the
other simulator modules, and its lint inventory and replay matrix.

The twin module also holds the port's versions of `tests/conftest.py`'s
fixtures (`cluster`, `fs`, `small_cluster`, which shadow the
reference's), the port's sanitizer guard, and an autouse fixture that
puts every cluster a test builds on the CPU by patching the keyword
default of `LustreCluster.__init__` for the test's duration (the port's
default device stays "cuda").

Reference tests that already have a hand-written twin are left out of
their twin module (`load(..., twinned=...)`) and run there instead:

  * test_lov.py: the raid5 tests (test_r5_parity_rotation_geometry,
    test_r5_logical_size_witnesses, test_raid5_round_trip_odd_size_and_rmw,
    test_raid5_ea_round_trip_preserves_pattern,
    test_raid5_degraded_read_is_byte_identical,
    test_raid5_degraded_write_and_parity_update,
    test_raid5_second_failure_is_an_error_not_garbage,
    test_raid5_rebuild_onto_spare_and_layout_swap,
    test_raid5_punch_recomputes_tail_parity) and
    test_raid1_resync_primary_side_stale: tests/test_torch_lov.py;
  * test_obd.py: test_snapshot_cow_versions, test_snapshot_readonly_enforced,
    test_snapshot_restore: tests/test_torch_simulator.py;
  * test_fsio.py: test_read_through_collaborative_cache:
    tests/test_torch_simulator.py;
  * test_changelog.py: the auditor and mirror tests
    (test_audit_mirror_matches_ground_truth_across_mdts,
    test_audit_mirror_tracks_sizes_and_hardlinks,
    test_audit_bootstrap_from_populated_namespace,
    test_audit_bootstrap_scan_races_with_activity,
    test_property_random_ops_mirror_matches_and_bookmarks_monotonic,
    test_mirror_standalone_displacing_rename): tests/test_torch_simulator.py;
  * test_chaos.py and test_namespace.py whole: tests/test_torch_simulator.py;
    test_ckpt.py: tests/test_torch_ckpt.py; test_lint.py:
    tests/test_torch_lint.py (none of these has a twin module).

A twin that fails shows a fault of the port: it is repaired in
`src/repro_torch/`, never here.
"""
import pathlib

import pytest

from test_torch_copies import port_source

TESTS = pathlib.Path(__file__).resolve().parent

# the reference suites' file paths, pointed at the port's tree
PORT_PATHS = (
    ('"src" / "repro" / "tools"', '"src" / "repro_torch" / "tools"'),
    ("from replay_matrix import REPLAY_MATRIX",
     "from repro_torch.tests.replay_matrix import REPLAY_MATRIX"),
)


def load(name: str, namespace: dict, twinned: tuple = ()) -> None:
    """Execute the ported text of tests/test_<name>.py in `namespace` (a
    twin module's globals), then drop the `twinned` tests."""
    path = TESTS / f"test_{name}.py"
    text = port_source(path.read_text())
    for old, new in PORT_PATHS:
        text = text.replace(old, new)
    own = namespace["__file__"]
    namespace["__file__"] = str(path)      # its paths resolve as there
    exec(compile(text, str(path), "exec"), namespace)
    namespace["__file__"] = own
    for test in twinned:
        del namespace[test]


torch = pytest.importorskip("torch")

from repro_torch.core import LustreCluster, sanitize  # noqa: E402
from repro_torch.fsio import LustreClient  # noqa: E402


@pytest.fixture(autouse=True)
def _clusters_on_cpu(monkeypatch):
    monkeypatch.setitem(LustreCluster.__init__.__kwdefaults__, "device",
                        "cpu")


@pytest.fixture(autouse=True)
def _port_sanitizer_guard():
    before = len(sanitize.state.violations)
    yield
    new = sanitize.state.violations[before:]
    assert not new, "port sanitizer violations:\n" + "\n".join(
        v.render() for v in new)


@pytest.fixture
def cluster():
    return LustreCluster(osts=4, mdses=2, clients=3, ost_failover=True,
                         commit_interval=16)


@pytest.fixture
def fs(cluster):
    return LustreClient(cluster).mount()


@pytest.fixture
def small_cluster():
    return LustreCluster(osts=2, mdses=1, clients=2, commit_interval=8)
