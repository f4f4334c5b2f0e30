"""Twin of tests/test_fsio.py on the port (see tests/_twin.py), but
for the tests twinned by hand in tests/test_torch_simulator.py."""
from _twin import load
from _twin import (_clusters_on_cpu, _port_sanitizer_guard,  # noqa: F401
                   cluster, fs, small_cluster)

load("fsio", globals(), twinned=(
    "test_read_through_collaborative_cache",
))
