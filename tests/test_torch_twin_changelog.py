"""Twin of tests/test_changelog.py on the port (see tests/_twin.py), but
for the tests twinned by hand in tests/test_torch_simulator.py."""
from _twin import load
from _twin import (_clusters_on_cpu, _port_sanitizer_guard,  # noqa: F401
                   cluster, fs, small_cluster)

load("changelog", globals(), twinned=(
    "test_audit_mirror_matches_ground_truth_across_mdts",
    "test_audit_mirror_tracks_sizes_and_hardlinks",
    "test_audit_bootstrap_from_populated_namespace",
    "test_audit_bootstrap_scan_races_with_activity",
    "test_property_random_ops_mirror_matches_and_bookmarks_monotonic",
    "test_mirror_standalone_displacing_rename",
))
