"""Collaborative cache — COBD + caching OST (paper §5.5, ch. 16).

A caching node runs a COBD (page cache of object extents, kept coherent by
PR extent locks on the *target* OST) fronted by a caching-OST service so
peer clients can read from it. The target OST's referral module (in ost.py)
redirects client reads to caching OSTs that hold covering PR locks; on a
miss the COBD populates itself through its own OSC (taking the PR lock the
referral logic later relies on).

"This can result in an unprecedented improvement in scalability for reads"
— bench_cobd.py measures exactly this claim (cluster-boot workload).
"""
from __future__ import annotations

from collections import defaultdict

from repro_torch.core import osc as osc_mod
from repro_torch.core import ptlrpc as R


class CachingOst(R.Target):
    """The OST-protocol service a caching node exports (§5.5.1: 'lock
    requests are still made to the target OST, so we disable lock granting
    at the caching OST — it simply services the read request')."""

    svc_kind = "ost"

    def __init__(self, uuid: str, node: R.Node, cobd: "Cobd"):
        super().__init__(uuid, node)
        self.cobd = cobd
        self.ops["read"] = self.op_read

    def op_read(self, req: R.Request) -> R.Reply:
        b = req.body
        data = self.cobd.read(b["group"], b["oid"], b["offset"], b["length"])
        self.sim.stats.add_bytes("cobd.served", len(data))
        return R.Reply(data={"len": len(data)}, bulk=data,
                       bulk_nbytes=len(data))


class Cobd:
    """Caching OBD: read-through page cache over an OSC (§5.5.1).

    Cached extents are covered by PR locks taken on the target OST; a
    blocking AST (writer appeared) invalidates the pages under the lock —
    exactly the paper's coherency story. Memory pressure is modelled with
    a byte budget + LRU."""

    PAGE = 4096

    def __init__(self, name: str, target_osc: osc_mod.Osc,
                 budget: int = 64 << 20):
        self.name = name
        self.osc = target_osc
        self.sim = target_osc.sim
        self.budget = budget
        self.used = 0
        # (group, oid) -> {page_index: bytes}
        self.pages: dict[tuple, dict[int, bytes]] = defaultdict(dict)
        self.lru: list[tuple] = []
        # invalidate on lock revocation. revoke_cbs (not flush_cb): the
        # COBD's locks are clean PR locks — the old flush_cb hook only
        # fired for DIRTY locks, so revocation never actually dropped the
        # cached pages (a writer left this cache permanently stale).
        def cb(lock):
            if lock.res_name[0] == "ext":
                self._invalidate(lock.res_name[1], lock.res_name[2])
        self.osc.locks.revoke_cbs.append(cb)

    # ------------------------------------------------------------- cache
    def _invalidate(self, group, oid):
        dropped = self.pages.pop((group, oid), None)
        if dropped:
            self.used -= sum(len(v) for v in dropped.values())
            self.sim.stats.count("cobd.invalidate")

    def _evict_until(self, need: int):
        while self.used + need > self.budget and self.lru:
            key = self.lru.pop(0)
            self._invalidate(*key)

    def read(self, group: int, oid: int, offset: int, length: int) -> bytes:
        key = (group, oid)
        pgs = self.pages[key]
        first, last = offset // self.PAGE, (offset + length - 1) // self.PAGE
        missing = [i for i in range(first, last + 1) if i not in pgs]
        if missing:
            self.sim.stats.count("cobd.miss")
            # populate through the standard OSC (takes the PR lock the
            # target OST's referral module will see; §5.5.2)
            start = missing[0] * self.PAGE
            end = (missing[-1] + 1) * self.PAGE
            data = self.osc.read(group, oid, start, end - start,
                                 from_cobd=self.name)
            self._evict_until(len(data))
            for i in range(missing[0], missing[-1] + 1):
                o = (i - missing[0]) * self.PAGE
                pg = data[o:o + self.PAGE]
                if pg:
                    pgs[i] = pg
                    self.used += len(pg)
            if key in self.lru:
                self.lru.remove(key)
            self.lru.append(key)
        else:
            self.sim.stats.count("cobd.hit")
        buf = bytearray()
        for i in range(first, last + 1):
            buf += pgs.get(i, b"")
        s = offset - first * self.PAGE
        return bytes(buf[s:s + length])


def make_caching_node(cluster, node_name: str, ost_target, uuid: str):
    """Wire a caching node: COBD + caching-OST service + referral
    registration on the target OST."""
    node = cluster.nodes[node_name]
    rpc = R.RpcClient(node)
    osc = osc_mod.Osc(rpc, ost_target.uuid,
                      [ost_target.node.nid], writeback=False)
    cobd = Cobd(uuid, osc)
    cost = CachingOst(uuid, node, cobd)
    ost_target.register_caching_ost(uuid, node.nid)
    return cobd, cost
