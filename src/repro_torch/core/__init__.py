"""Core Lustre architecture simulation, port of `repro.core`.

The modules are copies of the reference simulator; `lov` computes raid5
parity with the port's CUDA XOR kernel on the cluster's `device`.  Not
ported yet: `cobd`, `snapshot`, `chaos`.
"""
from repro_torch.core.cluster import LustreCluster  # noqa: F401
