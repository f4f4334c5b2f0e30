"""Raw object bytes of a striped file, for comparing two clusters.

Works on a cluster of either package (`repro` or `repro_torch`): it
touches only `cluster.target(uuid).obd`, the OST's FilterDevice, and the
stripe layout's `objects` list, so the tests can hold the port's stored
bytes (parity units included) against the reference's byte for byte.
"""
from __future__ import annotations


def object_bytes(cluster, lsm) -> list[bytes]:
    """Each slot's whole object, in slot order.  `lsm` is a StripeMd of
    either package or its `to_ea()` dict."""
    objects = lsm["objects"] if isinstance(lsm, dict) else lsm.objects
    out = []
    for o in objects:
        obd = cluster.target(o["ost"]).obd
        size = obd.getattr(o["group"], o["oid"])["size"]
        out.append(obd.read(o["group"], o["oid"], 0, size))
    return out
