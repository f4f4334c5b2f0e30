"""Twin of tests/test_obd.py on the port (see tests/_twin.py), but
for the tests twinned by hand in tests/test_torch_simulator.py."""
from _twin import load
from _twin import (_clusters_on_cpu, _port_sanitizer_guard,  # noqa: F401
                   cluster, fs, small_cluster)

load("obd", globals(), twinned=(
    "test_snapshot_cow_versions",
    "test_snapshot_readonly_enforced",
    "test_snapshot_restore",
))
