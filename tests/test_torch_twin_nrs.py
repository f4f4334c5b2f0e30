"""Twin of tests/test_nrs.py on the port (see tests/_twin.py)."""
from _twin import load
from _twin import (_clusters_on_cpu, _port_sanitizer_guard,  # noqa: F401
                   cluster, fs, small_cluster)

load("nrs", globals())
