"""Core Lustre architecture simulation (the paper's contribution).

Layers (bottom up, mirroring Part 1 of the paper):
    sim        — virtual clock / link model / fault injection
    portals    — message passing: portals, match entries, MDs, events (ch.4)
    ptlrpc     — request processing: xids, exports/imports, bulk,
                 transactions + replay/resend recovery (ch.4, 22, 23, 29)
    nrs        — network request scheduler: pluggable per-target request
                 ordering policies (fifo/crr/orr/tbf) + accounting
    dlm        — distributed lock manager: 6 modes, extents, intents, ASTs
                 (ch.7, 27)
    obd        — object devices: class driver + filter direct driver (ch.5)
    llog       — logging API: catalogs, cookies, cancellation (ch.8)
    changelog  — per-MDT metadata activity streams on llog: typed records,
                 consumer bookmarks, jobid tagging (ch.8 + audit tooling)
    ost / osc  — object storage target/client, grants, referral (ch.2, 10)
    lov        — striping + RAID1 redundant OSTs (ch.10, 15, 20)
    mds / mdc  — metadata service: fids, intents, reintegration, clustered
                 directories, WBC (ch.6, 17, 26)
    cobd       — collaborative read cache (ch.5.5, 16)
    snapshot   — snapshot logical driver, COW redirectors (ch.5.4)
    recovery   — pinger, failover rings, consistent-cut snapshot (ch.11, 29)
    cluster    — configuration management / assembly (ch.13, 14, 31)
"""
from repro_torch.core.cluster import LustreCluster  # noqa: F401
