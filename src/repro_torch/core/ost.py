"""Object Storage Target (paper ch. 2.2, 5, 10.12, 23.4).

An OST wraps a direct OBD device (FilterDevice) behind the OST network
protocol, embeds a DLM namespace for *extent* locks on its objects, manages
client *grants* (space pre-allocated to clients so they can write back
cached dirty data without ENOSPC surprises, ch. 10.12), and hosts the
*referral* module that redirects reads to collaborative caches (§5.5.2).

Bulk data rides on the request's `bulk_nbytes` (timing) + the reply `bulk`
field (payload) — the niobuf vector of §4.5.6.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import dlm as dlm_mod
from repro_torch.core import obd as obd_mod
from repro_torch.core import ptlrpc as R

INITIAL_GRANT = 2 << 20        # 2 MB on connect
GRANT_CHUNK = 8 << 20


class OstTarget(R.Target):
    svc_kind = "ost"

    def __init__(self, uuid: str, node: R.Node, capacity: int = 1 << 40):
        super().__init__(uuid, node)
        self.obd = obd_mod.FilterDevice(f"{uuid}-filter", capacity)
        self.obd.txn_hook = self.txn
        self.rpc = R.RpcClient(node)
        self.ldlm = dlm_mod.LdlmNamespace(
            self, self.rpc, lvb_update=self._lvb_update)
        # referral/policy module (§5.5.2): caching OST uuid -> nid
        self.caching_osts: dict[str, str] = {}
        self.referral_rr = 0
        # per-jobid I/O byte attribution, {jobid: {"read": n, "write": n}}:
        # server-side ground truth for "how fast is the rebuild job
        # actually moving" vs the client jobs sharing this spindle
        self.jobid_bytes: dict[str, dict] = {}
        ops = self.ops
        ops["connect"] = self.op_connect
        ops["disconnect"] = self.op_disconnect
        ops["ping"] = self.op_ping
        ops["create"] = self.op_create
        ops["destroy"] = self.op_destroy
        ops["getattr"] = self.op_getattr
        ops["setattr"] = self.op_setattr
        ops["read"] = self.op_read
        ops["write"] = self.op_write
        ops["punch"] = self.op_punch
        ops["glimpse_bulk"] = self.op_glimpse_bulk
        ops["statfs"] = self.op_statfs
        ops["sync"] = self.op_sync
        ops["list_objects"] = self.op_list_objects
        ops["llog_cancel"] = self.op_llog_cancel
        ops["orphan_cleanup"] = self.op_orphan_cleanup
        ops["grant_shrink"] = self.op_grant_shrink

    # ---------------------------------------------------- VBR
    def vbr_keys_for(self, req: R.Request) -> list:
        """Every object mutation versions its (group, oid).  `create` is
        deliberately untracked: a pinned-oid replay either finds its
        object alive (idempotent) or rebirths it — no older mutation can
        conflict with an object's own birth."""
        if req.opcode in ("write", "setattr", "punch", "destroy"):
            b = req.body
            if b.get("oid") is not None:
                return [("obj", b["group"], b["oid"])]
        return []

    # ------------------------------------------------------------- locks
    def _lvb_update(self, res: dlm_mod.Resource):
        if res.name[0] != "ext":
            return
        _, group, oid = res.name
        try:
            attrs = self.obd.getattr(group, oid)
            res.lvb.update(size=attrs["size"], mtime=attrs["mtime"])
        except obd_mod.ObdError:
            pass

    # ------------------------------------------------------------ grants
    def _grant_for(self, exp: R.Export, want: int) -> int:
        free = self.obd.statfs()["free"]
        cur = exp.data.get("grant", 0)
        add = max(0, min(want, free // max(1, 2 * len(self.exports)) - cur))
        exp.data["grant"] = cur + add
        return exp.data["grant"]

    def op_connect(self, req: R.Request) -> R.Reply:
        rep = super().op_connect(req)
        exp = self.exports[req.client_uuid]
        rep.data["grant"] = self._grant_for(exp, INITIAL_GRANT)
        return rep

    def op_grant_shrink(self, req: R.Request) -> R.Reply:
        """Client returns idle grant down to an absolute `keep` target
        (idempotent: a resent shrink converges to the same number).
        Grant bookkeeping is volatile export state — no transno."""
        exp = self.exports[req.client_uuid]
        keep = max(0, int(req.body.get("keep", 0)))
        cur = exp.data.get("grant", 0)
        if cur > keep:
            self.sim.stats.count("ost.grant_shrunk_bytes", cur - keep)
            exp.data["grant"] = keep
        return R.Reply(data={"grant": exp.data.get("grant", 0)})

    # ---------------------------------------------------------- monitor
    def mon_stats(self) -> dict:
        sf = self.obd.statfs()
        return {
            "space": {"capacity": sf["capacity"], "free": sf["free"],
                      "objects": len(self.obd.objects)},
            "grant": {
                "granted_total": sum(e.data.get("grant", 0)
                                     for e in self.exports.values()),
                "shrunk_bytes": self.sim.stats.node_counters
                                .get(self.uuid, {})
                                .get("ost.grant_shrunk_bytes", 0),
            },
            "locks": {
                "resources": len(self.ldlm.resources),
                "granted": sum(len(r.granted)
                               for r in self.ldlm.resources.values()),
                "waiting": sum(len(r.waiting)
                               for r in self.ldlm.resources.values()),
            },
            "jobid_bytes": {j: dict(v)
                            for j, v in self.jobid_bytes.items()},
        }

    def _note_jobid_io(self, req: R.Request, kind: str, nbytes: int):
        jobid = getattr(req, "jobid", "") or ""
        if not jobid or not nbytes:
            return
        slot = self.jobid_bytes.setdefault(jobid, {"read": 0, "write": 0})
        slot[kind] += nbytes

    # ----------------------------------------------------------- obd ops
    def _wrap(self, fn, *a, **kw):
        try:
            return fn(*a, **kw)
        except obd_mod.ObdError as e:
            raise R.RpcError(-e.errno, str(e))

    def op_create(self, req: R.Request) -> R.Reply:
        b = req.body
        if req.replay and b.get("oid") is not None:
            # replayed create of an object that survived: idempotent
            try:
                self.obd.getattr(b["group"], b["oid"])
                return R.Reply(data={"group": b["group"], "oid": b["oid"]},
                               transno=self.transno)
            except obd_mod.ObdError:
                pass
        out = self._wrap(self.obd.create, b["group"], b.get("oid"),
                         **b.get("attrs", {}))
        return R.Reply(data=out, transno=out["transno"])

    def op_destroy(self, req: R.Request) -> R.Reply:
        b = req.body
        try:
            out = self.obd.destroy(b["group"], b["oid"])
        except obd_mod.ObdError:
            return R.Reply(data={"transno": 0})     # idempotent for replay
        # cancel llog cookie shipped with the destroy (ch. 8.4)
        if b.get("cookie"):
            self.obd.llog("unlink-client").cancel([b["cookie"]])
        return R.Reply(data=out, transno=out["transno"])

    def op_getattr(self, req: R.Request) -> R.Reply:
        b = req.body
        return R.Reply(data=self._wrap(self.obd.getattr, b["group"], b["oid"]))

    def op_glimpse_bulk(self, req: R.Request) -> R.Reply:
        """Vectored glimpse (§7.7): ONE RPC answers size/mtime for MANY
        objects of this OST — a striped-directory scan ships one of
        these per OST instead of one getattr per stripe object. Each
        object's LVB merges disk state with what PW holders report over
        glimpse ASTs, so writers keep their locks and caches."""
        out = []
        for g, o in req.body["objects"]:
            try:
                a = self.obd.getattr(g, o)
            except obd_mod.ObdError:
                out.append(None)
                continue
            lvb = self.ldlm.glimpse_lvb(
                ("ext", g, o), base={"size": a["size"],
                                     "mtime": a["mtime"]})
            out.append({"size": lvb.get("size", 0),
                        "mtime": lvb.get("mtime", 0.0)})
        self.sim.stats.count("ost.glimpse_objects", len(out))
        return R.Reply(data={"attrs": out}, bulk_nbytes=R.wire_size(out))

    def op_setattr(self, req: R.Request) -> R.Reply:
        b = req.body
        out = self._wrap(self.obd.setattr, b["group"], b["oid"],
                         **b.get("attrs", {}))
        return R.Reply(data=out, transno=out["transno"])

    def _maybe_refer(self, req: R.Request, group: int, oid: int,
                     ext: tuple) -> R.Reply | None:
        """Referral module: redirect to a collaborative cache when some
        caching OST holds a PR lock covering the extent (§5.5.2), or --
        cache-population policy -- round-robin when none does. Reads
        FROM a COBD (populating its cache) are never re-referred."""
        b = req.body
        if not self.caching_osts or b.get("no_referral") \
                or b.get("_from_cobd"):
            return None
        holders = self.ldlm.resources.get(("ext", group, oid))
        cached = []
        if holders:
            for lk in holders.granted:
                if (lk.client_uuid in self.caching_osts
                        and lk.mode == "PR"
                        and dlm_mod.overlaps(lk.extent, ext)):
                    cached.append(lk.client_uuid)
        if cached:
            pick = cached[self.referral_rr % len(cached)]
        else:
            pick = list(self.caching_osts)[
                self.referral_rr % len(self.caching_osts)]
        self.referral_rr += 1
        self.sim.stats.count("ost.referral")
        return R.Reply(data={"referral": {
            "uuid": pick, "nid": self.caching_osts[pick]}})

    def op_read(self, req: R.Request) -> R.Reply:
        b = req.body
        group, oid = b["group"], b["oid"]
        if "niobufs" in b:
            # vectored BRW read: one reply carries the whole niobuf vector
            nio = b["niobufs"]
            span = (min(n["offset"] for n in nio),
                    max(n["offset"] + n["length"] for n in nio))
            ref = self._maybe_refer(req, group, oid, span)
            if ref is not None:
                return ref
            chunks = [self._wrap(self.obd.read, group, oid,
                                 n["offset"], n["length"]) for n in nio]
            total = sum(len(c) for c in chunks)
            self.sim.stats.add_bytes("ost.read", total)
            self._note_jobid_io(req, "read", total)
            self.sim.stats.count("ost.brw_read_niobufs", len(nio))
            return R.Reply(data={"len": total, "niobufs": len(nio)},
                           bulk=chunks, bulk_nbytes=total)
        ref = self._maybe_refer(req, group, oid,
                                (b["offset"], b["offset"] + b["length"]))
        if ref is not None:
            return ref
        data = self._wrap(self.obd.read, group, oid, b["offset"], b["length"])
        self.sim.stats.add_bytes("ost.read", len(data))
        self._note_jobid_io(req, "read", len(data))
        return R.Reply(data={"len": len(data)}, bulk=data,
                       bulk_nbytes=len(data))

    def op_write(self, req: R.Request) -> R.Reply:
        b = req.body
        if "niobufs" in b:
            # vectored BRW write: apply the whole niobuf vector in ONE
            # backend transaction and answer with a single reply
            iov = [(n["offset"], n["data"]) for n in b["niobufs"]]
            out = self._wrap(self.obd.writev, b["group"], b["oid"], iov,
                             b.get("mtime", self.sim.now))
            total = sum(len(d) for _, d in iov)
            self.sim.stats.count("ost.brw_write_niobufs", len(iov))
        else:
            data = b["data"]
            out = self._wrap(self.obd.write, b["group"], b["oid"],
                             b["offset"], data,
                             b.get("mtime", self.sim.now))
            total = len(data)
        self.sim.stats.add_bytes("ost.write", total)
        self._note_jobid_io(req, "write", total)
        exp = self.exports[req.client_uuid]
        exp.data["grant"] = max(0, exp.data.get("grant", 0) - total)
        self.ldlm.bump_version(("ext", b["group"], b["oid"]), size=out["size"])
        return R.Reply(data={"size": out["size"],
                             "grant": self._grant_for(exp, GRANT_CHUNK)},
                       transno=out["transno"])

    def op_punch(self, req: R.Request) -> R.Reply:
        b = req.body
        out = self._wrap(self.obd.punch, b["group"], b["oid"], b["size"])
        return R.Reply(data=out, transno=out.get("transno", 0))

    def op_statfs(self, req: R.Request) -> R.Reply:
        return R.Reply(data=self.obd.statfs())

    def op_sync(self, req: R.Request) -> R.Reply:
        self.commit()
        return R.Reply(data={"last_committed": self.committed_transno})

    def op_list_objects(self, req: R.Request) -> R.Reply:
        return R.Reply(data=self.obd.list_objects(req.body["group"]))

    def op_llog_cancel(self, req: R.Request) -> R.Reply:
        n = self.obd.llog(req.body["catalog"]).cancel(req.body["cookies"])
        return R.Reply(data={"cancelled": n})

    def op_orphan_cleanup(self, req: R.Request) -> R.Reply:
        """MDS-driven orphan deletion after MDS recovery (§6.7.5): destroy
        objects in `group` above `last_used` oid that no file references."""
        b = req.body
        doomed = [oid for oid in self.obd.list_objects(b["group"])
                  if oid > b["last_used"] and oid not in set(b.get("keep", ()))]
        for oid in doomed:
            self.obd.destroy(b["group"], oid)
        self.sim.stats.count("ost.orphans_destroyed", len(doomed))
        return R.Reply(data={"destroyed": doomed})

    # --------------------------------------------------------- lifecycle
    def register_caching_ost(self, uuid: str, nid: str):
        self.caching_osts[uuid] = nid
