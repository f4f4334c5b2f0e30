"""Twin of tests/test_lov.py on the port (see tests/_twin.py), but
for the tests twinned by hand in tests/test_torch_lov.py."""
from _twin import load
from _twin import (_clusters_on_cpu, _port_sanitizer_guard,  # noqa: F401
                   cluster, fs, small_cluster)

load("lov", globals(), twinned=(
    "test_r5_parity_rotation_geometry",
    "test_r5_logical_size_witnesses",
    "test_raid5_round_trip_odd_size_and_rmw",
    "test_raid5_ea_round_trip_preserves_pattern",
    "test_raid5_degraded_read_is_byte_identical",
    "test_raid5_degraded_write_and_parity_update",
    "test_raid5_second_failure_is_an_error_not_garbage",
    "test_raid5_rebuild_onto_spare_and_layout_swap",
    "test_raid5_punch_recomputes_tail_parity",
    "test_raid1_resync_primary_side_stale",
))
