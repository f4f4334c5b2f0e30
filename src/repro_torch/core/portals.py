"""Portals message-passing layer (paper ch. 4, 22, 24, 40).

Faithful concepts: a *portal table* per network interface (NI), each portal
entry holding a list of *match entries* that gate delivery into *memory
descriptors*; *events* (PUT/GET/REPLY/ACK/SENT/UNLINK/DROP) written into
*event queues* with optional handlers; `put`/`get` data movement; NAL link
types with different latency/bandwidth; *routing* through gateway nodes with
load balancing over equivalent routes and `lctl set_gw up|down` style
enable/disable (§4.4).

Delivery is synchronous (the receiver's event handler runs inline) while the
virtual clock models transfer time per hop.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import defaultdict
from typing import Any, Callable, Optional

from repro_torch.core.sim import NALS, LinkSpec, Simulator

# Event kinds
PUT, GET, REPLY, ACK, SENT, UNLINK, DROP = (
    "PUT", "GET", "REPLY", "ACK", "SENT", "UNLINK", "DROP")

IGNORE_ALL = (1 << 64) - 1


@dataclasses.dataclass
class Event:
    kind: str
    initiator: "Nid"
    portal: int
    match_bits: int
    rlength: int
    offset: int
    md: "MemoryDescriptor"
    data: Any = None
    arrival_time: float = 0.0


@dataclasses.dataclass
class MemoryDescriptor:
    """A receive/send buffer. `buffer` holds python payloads (we model the
    wire as structured objects + an explicit byte length for timing)."""
    length: int
    threshold: int = 1                 # auto-unlink after N operations
    options: int = 0
    user_ptr: Any = None
    eq: Optional["EventQueue"] = None
    manage_remote_offset: bool = False
    # state
    buffer: list = dataclasses.field(default_factory=list)
    local_offset: int = 0
    unlinked: bool = False

    def _consume(self, nbytes: int) -> int:
        off = self.local_offset
        if self.manage_remote_offset:
            self.local_offset += nbytes
        self.threshold -= 1
        if self.threshold == 0:
            self.unlinked = True
        return off


@dataclasses.dataclass
class MatchEntry:
    match_bits: int
    ignore_bits: int
    md: MemoryDescriptor
    unlink_when_md: bool = True

    def matches(self, bits: int) -> bool:
        return (self.match_bits & ~self.ignore_bits) == (
            bits & ~self.ignore_bits)


class EventQueue:
    def __init__(self, handler: Callable[[Event], None] | None = None):
        self.handler = handler
        self.events: list[Event] = []

    def deliver(self, ev: Event):
        if self.handler is not None:
            self.handler(ev)
        else:
            self.events.append(ev)

    def pop(self) -> Event | None:
        return self.events.pop(0) if self.events else None


class Portal:
    def __init__(self):
        self.match_list: list[MatchEntry] = []

    def attach(self, me: MatchEntry, *, front: bool = False):
        if front:
            self.match_list.insert(0, me)
        else:
            self.match_list.append(me)

    def match(self, bits: int) -> MatchEntry | None:
        for me in self.match_list:
            if not me.md.unlinked and me.matches(bits):
                return me
        return None

    def gc(self):
        self.match_list = [m for m in self.match_list if not m.md.unlinked]


class NI:
    """Network interface: one portal table on one node, one NAL."""

    def __init__(self, nid: str, nal: str, network: "PortalsNetwork"):
        self.nid = nid
        self.nal = nal
        self.network = network
        self.portals: dict[int, Portal] = defaultdict(Portal)
        network.register(self)

    # ---------------------------------------------------------------- API
    def me_attach(self, portal: int, match_bits: int, ignore_bits: int,
                  md: MemoryDescriptor, front: bool = False) -> MatchEntry:
        me = MatchEntry(match_bits, ignore_bits, md)
        self.portals[portal].attach(me, front=front)
        return me

    def put(self, target_nid: str, portal: int, match_bits: int, data: Any,
            nbytes: int, *, offset: int = 0, ack: bool = False,
            reply_ev: EventQueue | None = None) -> float:
        """Send `data` (nbytes on the wire) to target portal/match_bits.
        Returns arrival virtual time (callers waiting for the result advance
        the clock to it)."""
        return self.network.transmit(
            Message(kind=PUT, src=self.nid, dst=target_nid, portal=portal,
                    match_bits=match_bits, data=data, nbytes=nbytes,
                    offset=offset, want_ack=ack, reply_eq=reply_ev))

    def get(self, target_nid: str, portal: int, match_bits: int,
            nbytes: int, reply_md: MemoryDescriptor) -> float:
        return self.network.transmit(
            Message(kind=GET, src=self.nid, dst=target_nid, portal=portal,
                    match_bits=match_bits, data=None, nbytes=nbytes,
                    reply_md=reply_md))

    # ------------------------------------------------------------ receive
    def deliver(self, msg: "Message", arrival: float):
        portal = self.portals[msg.portal]
        me = portal.match(msg.match_bits)
        if me is None:
            # Unsolicited packet with no posted buffer: dropped (Portals
            # assumes pre-posted buffers; §4.3.1).
            self.network.sim.stats.count("portals.no_match_drop")
            return
        md = me.md
        if msg.kind == PUT:
            off = md._consume(msg.nbytes)
            md.buffer.append((off, msg.data))
            if md.eq:
                md.eq.deliver(Event(PUT, msg.src, msg.portal, msg.match_bits,
                                    msg.nbytes, off, md, msg.data, arrival))
            if msg.want_ack:
                self.network.transmit(Message(
                    kind=ACK, src=self.nid, dst=msg.src, portal=msg.portal,
                    match_bits=msg.match_bits, data=None, nbytes=0,
                    reply_eq=msg.reply_eq))
        elif msg.kind == GET:
            md._consume(msg.nbytes)
            payload = md.user_ptr
            if md.eq:
                md.eq.deliver(Event(GET, msg.src, msg.portal, msg.match_bits,
                                    msg.nbytes, 0, md, None, arrival))
            self.network.transmit(Message(
                kind=REPLY, src=self.nid, dst=msg.src, portal=msg.portal,
                match_bits=msg.match_bits, data=payload, nbytes=msg.nbytes,
                reply_md=msg.reply_md))
        elif msg.kind in (REPLY, ACK):
            pass
        portal.gc()


@dataclasses.dataclass
class Message:
    kind: str
    src: str
    dst: str
    portal: int
    match_bits: int
    data: Any
    nbytes: int
    offset: int = 0
    want_ack: bool = False
    reply_eq: EventQueue | None = None
    reply_md: MemoryDescriptor | None = None


@dataclasses.dataclass
class Route:
    """dst network -> gateway nid (paper §4.4: redundant gateways)."""
    net: str
    gateway: str
    enabled: bool = True


class PortalsNetwork:
    """In-process router. Nids look like "net:host", e.g. "elan:mds0".

    Same-net messages go direct; cross-net messages hop through an enabled
    gateway (load-balanced round-robin over equivalent routes). Every hop
    pays the NAL's latency + bandwidth and consults the fault plan.
    """

    def __init__(self, sim: Simulator):
        self.sim = sim
        self.nis: dict[str, NI] = {}
        self.routes: list[Route] = []
        self._rr = itertools.count()
        self.link_busy: dict[tuple, float] = defaultdict(float)
        self.upcalls: list = []            # (event, args) log (§4.4 upcall)

    def register(self, ni: NI):
        self.nis[ni.nid] = ni

    # ------------------------------------------------------------- routes
    def add_route(self, net: str, gateway: str):
        self.routes.append(Route(net, gateway))

    def set_gw(self, gateway: str, up: bool):
        """lctl --net <nal> set_gw <nid> {up|down} (§4.4.3)."""
        for r in self.routes:
            if r.gateway == gateway:
                r.enabled = up

    def _gateways(self, net: str) -> list[str]:
        return [r.gateway for r in self.routes
                if r.net == net and r.enabled
                and r.gateway not in self.sim.faults.down_nids]

    @staticmethod
    def net_of(nid: str) -> str:
        return nid.split(":", 1)[0]

    def _path(self, src: str, dst: str) -> list[str] | None:
        if self.net_of(src) == self.net_of(dst):
            return [src, dst]
        gws = self._gateways(self.net_of(dst))
        if not gws:
            return None
        gw = gws[next(self._rr) % len(gws)]
        return [src, gw, dst]

    # ------------------------------------------------------------ deliver
    def _hop_time(self, src: str, dst: str, nbytes: int, start: float):
        nal = NALS.get(self.net_of(dst), NALS["socknal"])
        link = (src, dst)
        begin = max(start, self.link_busy[link])
        done = (begin + nal.latency + nal.small_msg_cost
                + nbytes / nal.bandwidth
                + self.sim.faults.extra_latency(src, dst))
        self.link_busy[link] = done
        return done

    def transmit(self, msg: Message) -> float:
        """Route + deliver a message. Returns arrival virtual time; on drop
        returns +inf (callers see a timeout)."""
        st = self.sim.stats
        st.count(f"portals.{msg.kind.lower()}")
        st.add_bytes("portals.wire", msg.nbytes)
        path = self._path(msg.src, msg.dst)
        if path is None:
            st.count("portals.unreachable")   # ENETUNREACH (§4.4.3)
            return float("inf")
        t = self.sim.now
        for a, b in zip(path, path[1:]):
            if self.sim.faults.should_drop(a, b):
                st.count("portals.dropped")
                # NAL peer-death detection -> router notification + upcall
                if b in self.sim.faults.down_nids and self._is_gateway(b):
                    self.upcalls.append(("ROUTER_NOTIFY", b, "down"))
                return float("inf")
            t = self._hop_time(a, b, msg.nbytes, t)
        dst_ni = self.nis.get(msg.dst)
        if dst_ni is None:
            st.count("portals.no_ni")
            return float("inf")
        if msg.kind == REPLY and msg.reply_md is not None:
            md = msg.reply_md
            md._consume(msg.nbytes)
            md.buffer.append((0, msg.data))
            if md.eq:
                md.eq.deliver(Event(REPLY, msg.src, msg.portal,
                                    msg.match_bits, msg.nbytes, 0, md,
                                    msg.data, t))
            return t
        if msg.kind == ACK:
            if msg.reply_eq:
                msg.reply_eq.deliver(Event(ACK, msg.src, msg.portal,
                                           msg.match_bits, 0, 0, None, None,
                                           t))
            return t
        dst_ni.deliver(msg, t)
        return t

    def _is_gateway(self, nid: str) -> bool:
        return any(r.gateway == nid for r in self.routes)
