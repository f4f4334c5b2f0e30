"""Cluster assembly + configuration management (paper ch. 13, 14, 31).

The paper drives configuration from XML/LDAP profiles through `lconf`;
here a plain dict plays the XML role and `LustreCluster` plays lconf:
it instantiates nodes, OST/MDS targets (with failover standbys), routes,
and wires MDS<->OST / MDS<->MDS imports. An `lctl()` method exposes the
admin verbs used in the paper (set_gw up/down, fail/restart node, ...).

Example config:
    {"net": "elan",
     "osts": 4, "ost_capacity": 1 << 30, "ost_failover": True,
     "mdses": 2,
     "clients": 2,
     "gateways": [("tcp", "gw0"), ...]}   # cross-net routing
"""
from __future__ import annotations

from repro_torch.core import fail as fail_mod
from repro_torch.core import mdc as mdc_mod
from repro_torch.core import mds as mds_mod
from repro_torch.core import osc as osc_mod
from repro_torch.core import ost as ost_mod
from repro_torch.core import lov as lov_mod
from repro_torch.core import ptlrpc as R
from repro_torch.core import recovery as rec_mod
from repro_torch.kernels import ops


class LustreCluster(R.ClusterBase):
    def __init__(self, *, osts: int = 2, mdses: int = 1, clients: int = 1,
                 net: str = "elan", ost_capacity: int = 1 << 40,
                 ost_failover: bool = False, seed: int = 0,
                 commit_interval: int = 64, mds_split_threshold: int = 0,
                 nrs_policy: str = "fifo", nrs_params: dict | None = None,
                 max_pages_per_rpc: int = osc_mod.DEFAULT_MAX_PAGES_PER_RPC,
                 max_rpcs_in_flight: int = osc_mod.DEFAULT_MAX_RPCS_IN_FLIGHT,
                 vectored_brw: bool = True,
                 max_cached_mb: int = osc_mod.DEFAULT_MAX_CACHED_MB,
                 readahead_pages: int = osc_mod.DEFAULT_READAHEAD_PAGES,
                 dir_pages: int = 64, statahead_max: int = 32,
                 wbc_auto: bool = False, wbc_batch: int = 64,
                 wbc_max_dirty: int = 1024,
                 spare_osts: int = 0, rebuild_rate: float = 0.0,
                 rebuild_burst: float = 4.0,
                 adaptive_timeouts: bool = True,
                 at_min: float = R.AT_MIN, at_max: float = R.AT_MAX,
                 ping_evict_age: float = 0.0,
                 recovery_per_client: float = 0.1,
                 recovery_window_max: float = 30.0,
                 device="cuda"):
        super().__init__(seed)
        # where the raid5 parity kernel runs, for every LOV this cluster
        # builds (make_lov); "cuda" with no usable card raises here
        # rather than running on the CPU
        self.device = ops.resolve_device(device)
        self.net = net
        # recovery / health-plane knobs: adaptive_timeouts +
        # at_min/at_max are read by every Import built against this
        # cluster (per-opcode decayed-max service estimates instead of
        # the fixed DEFAULT_TIMEOUT); ping_evict_age > 0 arms the
        # server-side stale-export back-stop; recovery_per_client scales
        # each target's recovery window with its export count, capped at
        # recovery_window_max
        self.adaptive_timeouts = adaptive_timeouts
        self.at_min = at_min
        self.at_max = at_max
        self.ping_evict_age = ping_evict_age
        self.recovery_per_client = recovery_per_client
        self.recovery_window_max = recovery_window_max
        # client-side BRW pipeline + read cache knobs, handed to every
        # OSC built via make_oscs/make_lov (overridable per call);
        # readahead_pages is consumed by LustreClient's sequential-read
        # detector (0 disables readahead)
        self.max_pages_per_rpc = max_pages_per_rpc
        self.max_rpcs_in_flight = max_rpcs_in_flight
        self.vectored_brw = vectored_brw
        self.max_cached_mb = max_cached_mb
        self.readahead_pages = readahead_pages
        # metadata read-path knobs, consumed by LustreClient:
        # dir_pages = entries per readdir-plus page (0 = seed per-entry
        # scan path); statahead_max = attr-prefetch window for sequential
        # stat patterns (0 disables statahead)
        self.dir_pages = dir_pages
        self.statahead_max = statahead_max
        # metadata write-back cache knobs, consumed by
        # LustreClient: wbc_auto = enter WBC on the first metadata write
        # under a directory (the MDS §6.5.2 contention decision still
        # arbitrates); wbc_batch = records per reint_batch RPC (0 = one
        # RPC per flush); wbc_max_dirty = dirty-record cap forcing a
        # full flush (cache pressure)
        self.wbc_auto = wbc_auto
        self.wbc_batch = wbc_batch
        self.wbc_max_dirty = wbc_max_dirty
        # raid5 rebuild knobs: spare_osts = extra OST targets
        # excluded from stripe allocation, available as rebuild targets
        # (lctl("rebuild", dead, spare)); rebuild_rate > 0 installs the
        # two-level tbf_orr NRS policy on every OST with a
        # {"rebuild": rate} rule, throttling rebuild BRWs req/s while
        # leaving client classes unlimited (and disk-ordered)
        self.spare_osts = spare_osts
        self.rebuild_rate = rebuild_rate
        self.rebuild_burst = rebuild_burst
        self.ost_targets: list[ost_mod.OstTarget] = []
        self.spare_targets: list[ost_mod.OstTarget] = []
        self.mds_targets: list[mds_mod.MdsTarget] = []
        self.client_nodes: list[R.Node] = []

        # --- OST nodes (optionally paired for failover: shared storage,
        # standby node imports the same target on failure — ch. 13.8)
        for i in range(osts + spare_osts):
            node = R.Node(f"ost{i}", net, self)
            t = ost_mod.OstTarget(f"OST{i:04d}", node, ost_capacity)
            t.commit_interval = commit_interval
            if rebuild_rate > 0:
                t.service.set_policy("tbf_orr",
                                     rules={"rebuild": rebuild_rate},
                                     burst=rebuild_burst)
            elif nrs_policy != "fifo" or nrs_params:
                t.service.set_policy(nrs_policy, **(nrs_params or {}))
            (self.ost_targets if i < osts
             else self.spare_targets).append(t)
        self.spare_uuids = [t.uuid for t in self.spare_targets]
        self.ost_nids = {}
        for i, t in enumerate(self.ost_targets):
            ring = [t.node.nid]
            if ost_failover:
                # nearest left neighbour hosts the standby (§6.7.6.4)
                ring.append(self.ost_targets[(i + 1) % osts].node.nid)
            self.ost_nids[t.uuid] = ring
        for t in self.spare_targets:
            self.ost_nids[t.uuid] = [t.node.nid]

        # --- MDS cluster
        for i in range(mdses):
            node = R.Node(f"mds{i}", net, self)
            t = mds_mod.MdsTarget(f"MDS{i:04d}", node, inode_group=i)
            t.commit_interval = commit_interval
            if mds_split_threshold:
                t.SPLIT_THRESHOLD = mds_split_threshold
            self.mds_targets.append(t)
        self.mds_nids = {t.uuid: [t.node.nid] for t in self.mds_targets}
        for t in self.mds_targets:
            for u in self.mds_targets:
                if u is not t:
                    t.connect_peer(u.uuid, [u.node.nid])
            for o in self.ost_targets + self.spare_targets:
                t.connect_ost(o.uuid, self.ost_nids[o.uuid])

        # --- failover standby wiring: a restarted OST target can be
        # reached at the standby nid because the standby node also serves
        # the target object (shared-storage assumption).
        if ost_failover:
            for i, t in enumerate(self.ost_targets):
                standby = self.ost_targets[(i + 1) % osts].node
                standby.targets[t.uuid] = t

        # --- client nodes
        for i in range(clients):
            self.client_nodes.append(R.Node(f"client{i}", net, self))

        for t in (self.ost_targets + self.spare_targets
                  + self.mds_targets):
            t.at_enabled = adaptive_timeouts
            t.ping_evict_age = ping_evict_age
            t.recovery_per_client = recovery_per_client
            t.recovery_window_max = recovery_window_max

    # ------------------------------------------------------------ builders
    def make_client_rpc(self, idx: int = 0) -> R.RpcClient:
        return R.RpcClient(self.client_nodes[idx])

    def make_oscs(self, rpc: R.RpcClient, writeback=True, *,
                  spares: bool = False, **osc_kw):
        osc_kw.setdefault("max_pages_per_rpc", self.max_pages_per_rpc)
        osc_kw.setdefault("max_rpcs_in_flight", self.max_rpcs_in_flight)
        osc_kw.setdefault("vectored_brw", self.vectored_brw)
        osc_kw.setdefault("max_cached_mb", self.max_cached_mb)
        return [osc_mod.Osc(rpc, t.uuid, self.ost_nids[t.uuid],
                            writeback=writeback, **osc_kw)
                for t in (self.spare_targets if spares
                          else self.ost_targets)]

    def make_lov(self, rpc: R.RpcClient, policy: str = "round_robin",
                 group: int = 0, writeback=True, **osc_kw) -> lov_mod.Lov:
        return lov_mod.Lov(self.make_oscs(rpc, writeback, **osc_kw),
                           group=group, policy=policy,
                           spares=self.make_oscs(rpc, writeback,
                                                 spares=True, **osc_kw),
                           device=self.device)

    def target(self, uuid: str):
        for t in self.ost_targets + self.spare_targets + self.mds_targets:
            if t.uuid == uuid:
                return t
        raise KeyError(uuid)

    def make_lmv(self, rpc: R.RpcClient) -> mdc_mod.Lmv:
        return mdc_mod.Lmv([
            mdc_mod.Mdc(rpc, t.uuid, self.mds_nids[t.uuid])
            for t in self.mds_targets])

    def mds_recovery(self, rpc: R.RpcClient) -> rec_mod.MdsClusterRecovery:
        return rec_mod.MdsClusterRecovery(rpc, self.mds_nids)

    def monitor(self, **kw):
        """The cluster's MELT-style collector (repro_torch.tools.monitor),
        created on first use; `lctl("mon_snapshot")` is the admin verb."""
        if getattr(self, "_monitor", None) is None:
            from repro_torch.tools.monitor import ClusterMonitor
            self._monitor = ClusterMonitor(self, **kw)
        return self._monitor

    # ---------------------------------------------------------------- ops
    def fail_node(self, name: str):
        self.nodes[name].fail()

    def restart_node(self, name: str):
        self.nodes[name].restart()

    def lctl(self, verb: str, *args):
        if verb == "set_gw":
            nid, state = args
            self.network.set_gw(nid, state == "up")
        elif verb == "fail":
            self.fail_node(args[0])
        elif verb == "restart":
            self.restart_node(args[0])
        elif verb == "drop_next":
            self.sim.faults.drop_next[args[0]] += int(args[1])
        elif verb == "nrs":
            # lctl("nrs", target_uuid, policy_name[, params_dict])
            uuid, policy = args[0], args[1]
            params = args[2] if len(args) > 2 else {}
            self.target(uuid).service.set_policy(policy, **params)
        elif verb == "changelog_register":
            # lctl("changelog_register", mds_uuid) -> consumer id
            t = self.target(args[0])
            uid = t.changelog.register()
            t.commit()          # the id handed out survives restart
            return uid
        elif verb == "changelog_deregister":
            # lctl("changelog_deregister", mds_uuid, consumer_id)
            t = self.target(args[0])
            t.changelog.deregister(args[1])
            t.commit()      # durable: a crash must not resurrect the pin
        elif verb == "changelog_info":
            # lctl("changelog_info", mds_uuid) -> consumer/record state
            return self.target(args[0]).changelog.info()
        elif verb == "changelog_gc":
            # lctl("changelog_gc", mds_uuid[, {"max_idle_indexes": n,
            #                                  "max_idle_time": s}])
            # sets the idle-consumer GC knobs (None disables one) and
            # runs a collection pass; returns the ids collected now
            t = self.target(args[0])
            cl = t.changelog
            if len(args) > 1:
                knobs = args[1]
                if "max_idle_indexes" in knobs:
                    cl.gc_max_idle_indexes = knobs["max_idle_indexes"]
                if "max_idle_time" in knobs:
                    cl.gc_max_idle_time = knobs["max_idle_time"]
            collected = cl.gc()
            if collected:
                t.commit()  # durable: a crash must not resurrect the pins
            return collected
        elif verb == "set_param":
            # lctl("set_param", "fail_loc", site[, nth[, action]]) arms an
            # OBD_FAIL failpoint (one-shot, fires on the nth hit); ""
            # disarms. action: crash (default) | drop | delay.
            # lctl("set_param", "fail_val", n) adjusts the hit count;
            # "fail_action"/"fail_delay" adjust the action knobs.
            if args[0] == "fail_loc":
                self.sim.fail.arm(args[1],
                                  args[2] if len(args) > 2 else None,
                                  args[3] if len(args) > 3 else None)
            elif args[0] == "fail_val":
                self.sim.fail.val = max(1, int(args[1]))
            elif args[0] == "fail_action":
                if args[1] not in fail_mod.ACTIONS:
                    raise ValueError(args[1])
                self.sim.fail.action = args[1]
            elif args[0] == "fail_delay":
                self.sim.fail.delay_s = float(args[1])
            elif args[0] in ("adaptive_timeouts", "at_min", "at_max",
                             "ping_evict_age", "recovery_per_client",
                             "recovery_window_max"):
                # health-plane knobs: cluster attr feeds new Imports;
                # server-side ones are pushed to live targets too
                val = (bool(args[1]) if args[0] == "adaptive_timeouts"
                       else float(args[1]))
                setattr(self, args[0], val)
                if args[0] != "at_min" and args[0] != "at_max":
                    attr = ("at_enabled"
                            if args[0] == "adaptive_timeouts" else args[0])
                    for t in (self.ost_targets + self.spare_targets
                              + self.mds_targets):
                        setattr(t, attr, val)
            else:
                raise ValueError(args[0])
        elif verb == "rebuild":
            # lctl("rebuild", dead_ost_uuid, spare_ost_uuid[, jobid])
            # walks the namespace with a maintenance client and rebuilds
            # every raid5 file referencing the dead OST onto the spare;
            # returns the rebuild report dict
            dead, spare = args[0], args[1]
            jobid = args[2] if len(args) > 2 else "rebuild"
            # local import: fsio sits above core in the layer stack, so a
            # module-level import here would be circular
            from repro_torch.fsio.client import LustreClient
            maint = LustreClient(self, node_idx=0)
            return maint.rebuild_ost(dead, spare, jobid=jobid)
        elif verb == "rebuild_throttle":
            # lctl("rebuild_throttle", rate[, burst]) installs the
            # two-level tbf_orr policy on every OST service, limiting the
            # "rebuild" jobid class to `rate` RPCs/s while other traffic
            # rides the orr_disk ordering unthrottled
            rate = float(args[0])
            burst = float(args[1]) if len(args) > 1 else self.rebuild_burst
            for t in self.ost_targets + self.spare_targets:
                t.service.set_policy("tbf_orr", rules={"rebuild": rate},
                                     burst=burst)
        elif verb == "recovery_close":
            # lctl("recovery_close", target_uuid) — admin closes the
            # recovery window early instead of waiting out the deadline
            # (VBR makes that safe: stragglers replay late).
            # mirror the RPC boundary's OBD_FAIL semantics: an armed
            # mds.recovery_window crash powers the target off here too
            t = self.target(args[0])
            try:
                t.close_recovery()
            except fail_mod.FailLocDrop:
                self.sim.stats.count("fail.drop")
            except fail_mod.FailLocHit:
                self.sim.stats.count("fail.crash")
                t.crash()
                t.restart()
        elif verb == "evict_client":
            # lctl("evict_client", target_uuid, client_uuid)
            self.target(args[0]).evict_client(args[1], reason="admin")
        elif verb == "mon_snapshot":
            # lctl("mon_snapshot") -> one cluster-wide aggregation round
            # over real RPCs (partial + 'stale' list when targets are
            # down); the snapshot tree is also the "monitor" procfs leaf
            return self.monitor().collect()
        elif verb == "get_param":
            # lctl("get_param", "wbc") -> one procfs section; dotted
            # paths walk into it ("wbc.flushes", "client_cache.hit_rate")
            node = self.procfs()
            for part in args[0].split("."):
                node = node[part]
            return node
        else:
            raise ValueError(verb)

    def _sanitizer_rollup(self) -> dict:
        san = self.sim.sanitize
        if san.enabled:
            # reading procfs is a natural audit point: run the final
            # counter-partition check before reporting
            san.check_counter_partition(self.sim.stats)
        return san.info()

    def procfs(self) -> dict:
        """lprocfs-style introspection tree (paper ch. 35): per-target
        state + cluster counters, as /proc/fs/lustre would expose."""
        cnt = self.sim.stats.counters
        hits, misses = cnt.get("osc.cache_hit", 0), cnt.get("osc.cache_miss", 0)
        out = {"counters": dict(cnt),
               "bytes": dict(self.sim.stats.bytes),
               "fail": self.sim.fail.info(),
               # runtime sanitizer rollup (checks run / violations /
               # captured-by-tests); a final counter-partition audit
               # runs here so the leaf is never stale
               "sanitizer": self._sanitizer_rollup(),
               # client read-cache rollup: the per-event
               # counters (osc.cache_*) live in "counters" too
               "client_cache": {
                   "hits": hits, "misses": misses,
                   "hit_rate": round(hits / (hits + misses), 4)
                   if hits + misses else 0.0,
                   "invalidations": cnt.get("osc.cache_invalidate", 0),
                   "lru_evictions": cnt.get("osc.cache_lru_evict", 0),
                   "readaheads": cnt.get("lov.readahead", 0),
               },
               # metadata read-path rollup: attr cache +
               # statahead + readdir-plus + batched glimpse
               "md_cache": {
                   "attr_hits": cnt.get("fs.attr_hit", 0),
                   "attr_misses": cnt.get("fs.attr_miss", 0),
                   "statahead": cnt.get("fs.statahead", 0),
                   "statahead_hits": cnt.get("fs.statahead_hit", 0),
                   "statahead_dropped": cnt.get("fs.statahead_dropped", 0),
                   "readdir_plus_pages": cnt.get("mds.intent.readdir", 0),
                   "glimpse_bulk_rpcs": cnt.get("rpc.ost.glimpse_bulk", 0),
                   "neg_hits": cnt.get("fs.neg_hit", 0),
               },
               # metadata write-back cache rollup: grant
               # decisions, local (RPC-free) updates, the flush pipeline
               # and its batch-size distribution, and how often an
               # unrepresentable op forced a flush-and-go-synchronous
               "wbc": {
                   "grants": cnt.get("wbc.granted", 0),
                   "denials": cnt.get("wbc.denied", 0),
                   "local_updates": cnt.get("wbc.local_update", 0),
                   "flushes": cnt.get("wbc.flush", 0),
                   "flushed_records": cnt.get("wbc.flushed_records", 0),
                   "batch_hist": {
                       k.rsplit(".", 1)[1]: v for k, v in sorted(
                           cnt.items(),
                           key=lambda kv: (len(kv[0]), kv[0]))
                       if k.startswith("wbc.batch_hist.")},
                   "fallback_sync": cnt.get("wbc.fallback_sync", 0),
                   "lost_records": cnt.get("wbc.lost_records", 0),
                   "reint_errors": cnt.get("wbc.reint_errors", 0),
               },
               # raid5/SNS rollup: degraded service, parity
               # reconstruction volume, and rebuild progress
               "raid": {
                   "degraded_reads": cnt.get("lov.degraded_read", 0),
                   "degraded_read_bytes": cnt.get("lov.degraded_read_bytes", 0),
                   "degraded_writes": cnt.get("lov.degraded_write", 0),
                   "reconstructed_units": cnt.get("lov.reconstruct_unit", 0),
                   "reconstructed_bytes": cnt.get("lov.reconstruct_bytes", 0),
                   "parity_writes": cnt.get("lov.parity_write", 0),
                   "parity_bytes": cnt.get("lov.parity_bytes", 0),
                   "rebuilt_objects": cnt.get("lov.rebuild_object", 0),
                   "rebuilt_bytes": cnt.get("lov.rebuild_bytes", 0),
                   "layout_swaps": cnt.get("lov.layout_swap", 0),
                   "rebuilds_aborted": cnt.get("lov.rebuild_aborted", 0),
                   "ost_deactivations": cnt.get("lov.ost_inactive", 0),
               },
               # recovery / health plane rollup: adaptive
               # timeouts, early replies, VBR admission decisions, and
               # the pinger's imperative-recovery + eviction activity
               "recovery": {
                   "early_replies": cnt.get("rpc.early_reply", 0),
                   "early_reply_rescues":
                       cnt.get("rpc.early_reply_rescue", 0),
                   "timeouts": cnt.get("rpc.timeout", 0),
                   "spurious_timeouts": cnt.get("rpc.timeout_spurious", 0),
                   "reconnect_backoffs":
                       cnt.get("rpc.reconnect_backoff", 0),
                   "imperative_recoveries":
                       cnt.get("rpc.imperative_recovery", 0),
                   "vbr_admits": cnt.get("rpc.vbr_admit", 0),
                   "vbr_evictions": cnt.get("rpc.vbr_eviction", 0),
                   "recovery_stragglers":
                       cnt.get("rpc.recovery_stragglers", 0),
                   "ping_evictions": cnt.get("rpc.ping_eviction", 0),
               },
               # monitoring plane: span registry roll-up + the
               # collector's last-snapshot summary; per-target per-node
               # counters appear under targets.<uuid>.counters below
               "metrics": self.sim.metrics.info(),
               "monitor": (self._monitor.info()
                           if getattr(self, "_monitor", None) else
                           {"snapshots": 0}),
               "targets": {}}
        for t in self.ost_targets + self.spare_targets:
            out["targets"][t.uuid] = {
                "kind": "obdfilter", "nid": t.node.nid,
                "spare": t in self.spare_targets,
                "boot_count": t.boot_count,
                "last_transno": t.transno,
                "last_committed": t.committed_transno,
                "recovering": t.recovering,
                "num_exports": len(t.exports),
                "kbytesfree": t.obd.statfs()["free"] >> 10,
                "num_objects": len(t.obd.objects),
                "locks": sum(len(r.granted)
                             for r in t.ldlm.resources.values()),
                "nrs": t.service.policy.info(),
                "counters": dict(
                    self.sim.stats.node_counters.get(t.uuid, {})),
                "latency": self.sim.metrics.target_summary(t.uuid),
            }
        for t in self.mds_targets:
            out["targets"][t.uuid] = {
                "kind": "mds", "nid": t.node.nid,
                "boot_count": t.boot_count,
                "last_transno": t.transno,
                "last_committed": t.committed_transno,
                "recovering": t.recovering,
                "num_exports": len(t.exports),
                "num_inodes": len(t.inodes),
                "pending_unlink_llog": len(t.unlink_llog.pending()),
                "locks": sum(len(r.granted)
                             for r in t.ldlm.resources.values()),
                "nrs": t.service.policy.info(),
                "changelog": t.changelog.info(),
                "cluster_cut": t.cluster_cut,
                "counters": dict(
                    self.sim.stats.node_counters.get(t.uuid, {})),
                "latency": self.sim.metrics.target_summary(t.uuid),
            }
        return out

    # ------------------------------------------------------------- stats
    @property
    def stats(self):
        return self.sim.stats

    @property
    def now(self):
        return self.sim.now
