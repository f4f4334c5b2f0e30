"""LOV: Logical Object Volume — RAID0 striping over OSTs (paper ch. 10, 20),
RAID1 mirroring and RAID5/SNS parity striping (ch. 15 Redundant Object
Storage Targets).

A file's stripe metadata (`lsm`: stripe_size / stripe_count / stripe_offset
+ per-stripe object ids) is stored by the MDS in the file inode's extended
attribute — the LOV only interprets it (§10.2). I/O maps logical extents to
per-object extents and issues the per-OST OSC calls in parallel (the
concurrency the paper's striping exists to exploit).

QOS allocation policy (ch. 20): round-robin or free-space weighted choice
of the starting OST / stripe set.

raid5 pattern: `stripe_count` DATA stripes plus ONE rotating parity stripe
per stripe-round, over `stripe_count + 1` objects.  Round r's parity lives
in slot (n-1 - r%n) % n (n = cnt+1), so parity load spreads over all OSTs
instead of hammering one (the classic RAID-4 bottleneck).  Parity is
computed on the LOV's `device` by the CUDA XOR kernel
(`kernels.ops.parity_bytes`; its plain version on the CPU); a read
whose OST is down is served DEGRADED by fetching the surviving stripes +
parity and reconstructing, and `rebuild_object` regenerates a dead OST's
object onto a spare.  XOR of all n units of a round is zero, so any one
missing unit — data or parity — is the XOR of the other n-1.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from repro_torch.core import osc as osc_mod
from repro_torch.core import ptlrpc as R
from repro_torch.kernels import ops


@dataclasses.dataclass
class StripeMd:
    """lsm — lives in the MDS inode EA ("lov" key).

    pattern "raid0": `objects` has stripe_count entries, all data.
    pattern "raid5": `objects` has stripe_count + 1 entries (slots); each
    stripe-round one slot holds parity (rotating), the rest hold the
    round's stripe_count data units.  Object-local offset of round r is
    always r * stripe_size, data or parity alike."""
    stripe_size: int
    stripe_count: int
    stripe_offset: int
    objects: list            # [{"ost": uuid, "group": g, "oid": o}, ...]
    pattern: str = "raid0"   # default keeps pre-raid5 EAs decodable

    def to_ea(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_ea(cls, ea: dict) -> "StripeMd":
        return cls(**ea)


def _chunks(lsm: StripeMd, offset: int, length: int):
    """Split a logical extent into (stripe_idx, obj_offset, length, lpos)
    runs.  Zero-length I/O yields no runs, every emitted run has length
    > 0 (extents ending exactly on a stripe boundary never produce an
    empty trailing run), and object-contiguous runs of the same stripe
    (stripe_count == 1) are merged so they coalesce into one niobuf."""
    ssz, cnt = lsm.stripe_size, lsm.stripe_count
    if length <= 0 or ssz <= 0 or cnt <= 0:
        return []
    out = []
    pos = offset
    end = offset + length
    while pos < end:
        snum = pos // ssz
        sidx = snum % cnt
        in_off = pos % ssz
        run = min(ssz - in_off, end - pos)
        obj_off = (snum // cnt) * ssz + in_off
        prev = out[-1] if out else None
        if (prev is not None and prev[0] == sidx
                and prev[1] + prev[2] == obj_off
                and prev[3] + prev[2] == pos):
            # same object, contiguous on both axes: extend the run
            out[-1] = (sidx, prev[1], prev[2] + run, prev[3])
        else:
            out.append((sidx, obj_off, run, pos))
        pos += run
    return out


def logical_size(lsm: StripeMd, obj_sizes: list[int]) -> int:
    """File size from per-object sizes (§10: size management)."""
    ssz, cnt = lsm.stripe_size, lsm.stripe_count
    best = 0
    for i, s in enumerate(obj_sizes):
        if s <= 0 or i >= cnt:
            continue
        last = s - 1
        logical_last = ((last // ssz) * cnt + i) * ssz + (last % ssz)
        best = max(best, logical_last + 1)
    return best


# ----------------------------------------------------- raid5 geometry

def _r5_parity_slot(lsm: StripeMd, r: int) -> int:
    """Slot holding round r's parity unit (left-symmetric rotation)."""
    n = lsm.stripe_count + 1
    return (n - 1 - (r % n)) % n


def _r5_slot(lsm: StripeMd, r: int, i: int) -> int:
    """Slot holding data unit i (0..cnt-1) of round r."""
    p = _r5_parity_slot(lsm, r)
    return i if i < p else i + 1


def _r5_chunks(lsm: StripeMd, offset: int, length: int):
    """Split a logical extent into (round, data_idx, in_off, run, lpos)
    data-unit runs (no merging: raid5 units are parity-coupled)."""
    ssz, cnt = lsm.stripe_size, lsm.stripe_count
    if length <= 0 or ssz <= 0 or cnt <= 0:
        return []
    out = []
    pos, end = offset, offset + length
    while pos < end:
        snum = pos // ssz
        r, i = divmod(snum, cnt)
        in_off = pos % ssz
        run = min(ssz - in_off, end - pos)
        out.append((r, i, in_off, run, pos))
        pos += run
    return out


def _r5_logical_size(lsm: StripeMd, slot_sizes: list) -> int:
    """File size from per-SLOT object sizes (None = size unknown, e.g.
    the OST is dead — that slot simply contributes no witness).

    Each object's last byte pins a logical position: if the slot holds
    DATA in its final round the mapping is direct; if it holds PARITY,
    the parity unit is exactly as long as the round's longest (first)
    data unit, so it witnesses data unit 0's extent instead."""
    ssz, cnt = lsm.stripe_size, lsm.stripe_count
    best = 0
    for s, size in enumerate(slot_sizes):
        if not size or size <= 0:
            continue
        rr, rem = divmod(size - 1, ssz)
        p = _r5_parity_slot(lsm, rr)
        if s == p:
            best = max(best, (rr * cnt) * ssz + rem + 1)
        else:
            i = s if s < p else s - 1
            best = max(best, ((rr * cnt) + i) * ssz + rem + 1)
    return best


class Lov:
    """Stripes over an ordered list of OSCs (one per OST)."""

    DEFAULT_STRIPE_SIZE = 1 << 20

    def __init__(self, oscs: list[osc_mod.Osc], group: int = 0,
                 policy: str = "round_robin",
                 spares: list[osc_mod.Osc] | None = None,
                 device="cuda"):
        self.oscs = oscs                  # allocation set
        self.spares = list(spares or [])  # rebuild targets, never allocated
        self.by_uuid = {o.uuid: o for o in oscs}
        for o in self.spares:
            self.by_uuid.setdefault(o.uuid, o)
        self.group = group
        self.policy = policy
        self._rr = itertools.count()
        self.sim = oscs[0].sim if oscs else None
        self.device = device              # where raid5 parity is computed

    # ------------------------------------------------------ admin state
    def is_active(self, uuid: str) -> bool:
        return self.by_uuid[uuid].active

    def set_active(self, uuid: str, on: bool):
        """Administratively (de)activate one OST's import — degraded
        raid5 paths fail fast (-19) instead of timing out per touch."""
        osc = self.by_uuid[uuid]
        if osc.active != on:
            osc.set_active(on)
            self.sim.stats.count(
                "lov.ost_active" if on else "lov.ost_inactive")

    def _mark_dead(self, osc: osc_mod.Osc):
        """Auto-detection: first TimeoutError_ marks the OST inactive so
        every later touch fails fast instead of re-walking reconnects."""
        if osc.active:
            osc.set_active(False)
            self.sim.stats.count("lov.ost_inactive")

    # ---------------------------------------------------------- allocate
    def _pick_offset(self, stripe_count: int) -> int:
        if self.policy == "free_space":
            frees = [(o.statfs()["free"], i) for i, o in enumerate(self.oscs)]
            return max(frees)[1]
        return next(self._rr) % len(self.oscs)

    def create(self, *, stripe_count: int = 0, stripe_size: int = 0,
               stripe_offset: int = -1, group: int | None = None,
               oids: list | None = None,
               pattern: str = "raid0") -> StripeMd:
        """Allocate stripe objects (one `create` per OST, in parallel).
        `oids` pins object ids (checkpoint restore / replay).  raid5
        allocates stripe_count + 1 objects (the extra rotating-parity
        slot), so stripe_count is capped at #OSTs - 1."""
        cnt = stripe_count or 1
        if pattern == "raid5":
            cnt = min(cnt, len(self.oscs) - 1)
            if cnt < 1:
                raise ValueError("raid5 needs >= 2 OSTs")
            nobj = cnt + 1
        else:
            cnt = min(cnt, len(self.oscs))
            nobj = cnt
        ssz = stripe_size or self.DEFAULT_STRIPE_SIZE
        off = stripe_offset if stripe_offset >= 0 else self._pick_offset(cnt)
        grp = self.group if group is None else group
        idxs = [(off + i) % len(self.oscs) for i in range(nobj)]

        def mk(i, k):
            osc = self.oscs[k]
            oid = oids[i] if oids else None
            out = osc.create(grp, oid)
            return {"ost": osc.uuid, "group": grp, "oid": out["oid"]}

        objs = self.sim.parallel(
            [(lambda i=i, k=k: mk(i, k)) for i, k in enumerate(idxs)])
        return StripeMd(ssz, cnt, off, objs, pattern)

    # --------------------------------------------------------------- I/O
    def _osc(self, lsm: StripeMd, sidx: int) -> osc_mod.Osc:
        return self.by_uuid[lsm.objects[sidx]["ost"]]

    def write(self, lsm: StripeMd, offset: int, data: bytes,
              gid: int = 0) -> int:
        """Striped write: logical runs are grouped per stripe object and
        dispatched concurrently as ONE vectored call per object (the OSC
        coalesces them into BRW niobuf vectors)."""
        if lsm.pattern == "raid5":
            return self._raid5_write(lsm, offset, data, gid=gid)
        runs = _chunks(lsm, offset, len(data))
        if not runs:
            return 0
        by_stripe: dict[int, list] = {}
        for sidx, obj_off, ln, lpos in runs:
            by_stripe.setdefault(sidx, []).append(
                (obj_off, data[lpos - offset:lpos - offset + ln]))

        def wr(sidx, iov):
            o = lsm.objects[sidx]
            self._osc(lsm, sidx).writev(o["group"], o["oid"], iov, gid=gid)

        self.sim.parallel([(lambda s=s, v=v: wr(s, v))
                           for s, v in by_stripe.items()])
        return len(data)

    def read(self, lsm: StripeMd, offset: int, length: int) -> bytes:
        """Striped read: one vectored OST_READ per stripe object, issued
        concurrently; partial results are merged by logical position."""
        if lsm.pattern == "raid5":
            return self._raid5_read(lsm, offset, length)
        runs = _chunks(lsm, offset, length)
        if not runs:
            return b""
        by_stripe: dict[int, list] = {}
        for sidx, obj_off, ln, lpos in runs:
            by_stripe.setdefault(sidx, []).append((obj_off, ln, lpos))

        def rd(sidx, iov):
            o = lsm.objects[sidx]
            chunks = self._osc(lsm, sidx).readv(
                o["group"], o["oid"], [(off, ln) for off, ln, _ in iov])
            return [(lpos, chunk)
                    for (_, _, lpos), chunk in zip(iov, chunks)]

        parts = self.sim.parallel([(lambda s=s, v=v: rd(s, v))
                                   for s, v in by_stripe.items()])
        buf = bytearray(length)
        for group in parts:
            for lpos, chunk in group:
                buf[lpos - offset:lpos - offset + len(chunk)] = chunk
        return bytes(buf)

    # ------------------------------------------------------------- raid5
    def _r5_read_slot_unit(self, lsm: StripeMd, r: int, s: int) -> bytes:
        """Read round r's whole unit from slot s (short past EOF)."""
        o = lsm.objects[s]
        return self.by_uuid[o["ost"]].readv(
            o["group"], o["oid"],
            [(r * lsm.stripe_size, lsm.stripe_size)], lock=False)[0]

    def _r5_rebuild_slot_unit(self, lsm: StripeMd, r: int,
                              dead: int) -> bytes:
        """Reconstruct round r's unit of slot `dead` from the other n-1
        slots via the XOR kernel.  Data unit: XOR(other data, parity)
        = `reconstruct`; parity unit: XOR(all data) = `xor_parity`.  The
        result is padded to the round's parity length — trailing zeros
        past the true unit end are the caller's to trim."""
        n = lsm.stripe_count + 1
        psl = _r5_parity_slot(lsm, r)

        def rd(s):
            try:
                return (s, self._r5_read_slot_unit(lsm, r, s))
            except (R.RpcError, R.TimeoutError_):
                return (s, None)

        parts = self.sim.parallel([(lambda s=s: rd(s))
                                   for s in range(n) if s != dead])
        by_slot = dict(parts)
        if any(u is None for u in by_slot.values()):
            raise R.RpcError(-5, "raid5: second OST failure during "
                                 "reconstruction")
        if dead == psl:
            datas = [u for s, u in sorted(by_slot.items()) if u]
            out = ops.parity_bytes(datas, device=self.device) \
                if datas else b""
        else:
            parity = by_slot[psl]
            if not parity:
                return b""             # round never written
            datas = [u for s, u in sorted(by_slot.items())
                     if s != psl and u]
            out = ops.reconstruct_bytes(datas, parity, len(parity),
                                        device=self.device)
        self.sim.stats.count("lov.reconstruct_unit")
        self.sim.stats.count("lov.reconstruct_bytes", len(out))
        return out

    def _r5_unit_data(self, lsm: StripeMd, r: int, i: int) -> bytes:
        """Current content of data unit i of round r, degraded-capable:
        if its OST is dead the unit is reconstructed from the others."""
        s = _r5_slot(lsm, r, i)
        osc = self.by_uuid[lsm.objects[s]["ost"]]
        try:
            return self._r5_read_slot_unit(lsm, r, s)
        except R.TimeoutError_:
            self._mark_dead(osc)
        except R.RpcError:
            pass
        # rstrip: the reconstruction is padded to parity length; genuine
        # trailing zeros in the unit are indistinguishable from padding
        # (documented caveat — affects only parity length, not bytes)
        return self._r5_rebuild_slot_unit(lsm, r, s).rstrip(b"\0")

    def _raid5_write(self, lsm: StripeMd, offset: int, data: bytes, *,
                     gid: int = 0) -> int:
        """Parity-coupled write: for every touched stripe-round, read-
        modify-write the round's data units, recompute parity with the
        XOR kernel, and ship data fragments + the parity unit as ONE
        vectored BRW per object, flushed write-through (parity must be
        durable WITH the data or the redundancy is a lie).  One dead
        OST degrades the write (its unit is recoverable from parity);
        two dead OSTs fail it with -5."""
        runs = _r5_chunks(lsm, offset, len(data))
        if not runs:
            return 0
        ssz, cnt = lsm.stripe_size, lsm.stripe_count
        by_round: dict[int, dict] = {}
        for r, i, in_off, ln, lpos in runs:
            by_round.setdefault(r, {})[i] = (in_off, ln, lpos)
        by_slot: dict[int, list] = {}     # slot -> [(obj_off, bytes)]
        pbytes = 0
        for r, touched in sorted(by_round.items()):
            units = []
            for i in range(cnt):
                if i in touched:
                    in_off, ln, lpos = touched[i]
                    frag = data[lpos - offset:lpos - offset + ln]
                    if in_off == 0 and ln == ssz:
                        unit = frag
                    else:                 # partial unit: read-modify
                        old = self._r5_unit_data(lsm, r, i)
                        u = bytearray(max(len(old), in_off + ln))
                        u[:len(old)] = old
                        u[in_off:in_off + ln] = frag
                        unit = bytes(u)
                    s = _r5_slot(lsm, r, i)
                    by_slot.setdefault(s, []).append(
                        (r * ssz + in_off, frag))
                else:                     # untouched unit still XORs in
                    unit = self._r5_unit_data(lsm, r, i)
                units.append(unit)
            live = [u for u in units if u]
            parity = ops.parity_bytes(live, device=self.device) \
                if live else b""
            if parity:
                by_slot.setdefault(_r5_parity_slot(lsm, r), []).append(
                    (r * ssz, parity))
                pbytes += len(parity)

        def wr(s, iov):
            o = lsm.objects[s]
            osc = self.by_uuid[o["ost"]]
            try:
                osc.writev(o["group"], o["oid"], iov, gid=gid)
                osc.flush(o["group"], o["oid"])
                return (s, True)
            except R.TimeoutError_:
                self._mark_dead(osc)
                return (s, False)
            except R.RpcError:
                return (s, False)

        outs = self.sim.parallel([(lambda s=s, v=v: wr(s, v))
                                  for s, v in sorted(by_slot.items())])
        failed = [s for s, ok in outs if not ok]
        if len(failed) > 1:
            raise R.RpcError(-5, "raid5: multiple OST failures on write")
        if failed:
            self.sim.stats.count("lov.degraded_write")
        self.sim.stats.count("lov.parity_write")
        self.sim.stats.count("lov.parity_bytes", pbytes)
        return len(data)

    def _raid5_read(self, lsm: StripeMd, offset: int, length: int) -> bytes:
        """Read with single-failure tolerance: one vectored OST_READ per
        live slot; runs on a failed slot are served by reconstructing
        the whole unit from survivors + parity (the XOR kernel)."""
        runs = _r5_chunks(lsm, offset, length)
        if not runs:
            return b""
        ssz = lsm.stripe_size
        by_slot: dict[int, list] = {}
        for r, i, in_off, ln, lpos in runs:
            by_slot.setdefault(_r5_slot(lsm, r, i), []).append(
                (r, i, in_off, ln, lpos))

        def rd(s, items):
            o = lsm.objects[s]
            osc = self.by_uuid[o["ost"]]
            try:
                return (s, osc.readv(
                    o["group"], o["oid"],
                    [(r * ssz + in_off, ln)
                     for r, _, in_off, ln, _ in items]))
            except R.TimeoutError_:
                self._mark_dead(osc)
                return (s, None)
            except R.RpcError:
                return (s, None)

        parts = self.sim.parallel([(lambda s=s, it=it: rd(s, it))
                                   for s, it in sorted(by_slot.items())])
        buf = bytearray(length)
        degraded = False
        for s, chunks in parts:
            items = by_slot[s]
            if chunks is None:            # dead slot: reconstruct units
                degraded = True
                for r, i, in_off, ln, lpos in items:
                    unit = self._r5_rebuild_slot_unit(lsm, r, s)
                    piece = unit[in_off:in_off + ln]
                    buf[lpos - offset:lpos - offset + len(piece)] = piece
                continue
            for (r, i, in_off, ln, lpos), chunk in zip(items, chunks):
                buf[lpos - offset:lpos - offset + len(chunk)] = chunk
        if degraded:
            self.sim.stats.count("lov.degraded_read")
            self.sim.stats.count("lov.degraded_read_bytes", length)
        return bytes(buf)

    def _r5_slot_sizes(self, lsm: StripeMd, *, locked: bool = False):
        """Per-slot object sizes; None where the OST is unreachable."""
        def ga(s):
            o = lsm.objects[s]
            osc = self.by_uuid[o["ost"]]
            try:
                if locked:
                    return osc.getattr_locked(o["group"], o["oid"])
                return osc.getattr(o["group"], o["oid"])
            except R.TimeoutError_:
                self._mark_dead(osc)
                return None
            except R.RpcError:
                return None

        return self.sim.parallel([(lambda s=s: ga(s))
                                  for s in range(len(lsm.objects))])

    def _r5_degraded_size(self, lsm: StripeMd, slot_sizes: list,
                          dead: int) -> int:
        """Logical size with one dead slot: survivors witness what they
        can (`_r5_logical_size`); the dead slot may hold the logical
        tail, so its unit in the last existing round is reconstructed
        and its trailing-zero-trimmed length extends the estimate
        (genuine trailing zeros in the tail unit are indistinguishable
        from reconstruction padding — documented caveat)."""
        ssz, cnt = lsm.stripe_size, lsm.stripe_count
        best = _r5_logical_size(lsm, slot_sizes)
        sizes = [s for s in slot_sizes if s]
        if not sizes:
            return best
        for rr in range((max(sizes) - 1) // ssz, -1, -1):
            p = _r5_parity_slot(lsm, rr)
            if dead == p:
                continue                  # parity unit: no logical bytes
            i = dead if dead < p else dead - 1
            unit = self._r5_rebuild_slot_unit(lsm, rr, dead).rstrip(b"\0")
            if unit:
                best = max(best, ((rr * cnt) + i) * ssz + len(unit))
            break    # lower rounds can't extend past a survivor witness
        return best

    def _r5_getattr(self, lsm: StripeMd, *, locked: bool) -> dict:
        attrs = self._r5_slot_sizes(lsm, locked=locked)
        deadset = [s for s, a in enumerate(attrs) if a is None]
        if len(deadset) > 1:
            raise R.RpcError(-5, "raid5: multiple OST failures")
        sizes = [None if a is None else a["size"] for a in attrs]
        if deadset:
            size = self._r5_degraded_size(lsm, sizes, deadset[0])
        else:
            size = _r5_logical_size(lsm, sizes)
        live = [a for a in attrs if a is not None]
        out = {"size": size,
               "mtime": max((a["mtime"] for a in live), default=0.0)}
        if not locked:
            out["blocks"] = sum(a.get("blocks", 0) for a in live)
        return out

    @staticmethod
    def _r5_obj_size_for(lsm: StripeMd, s: int, logical: int) -> int:
        """Slot s's object size when the file is `logical` bytes long."""
        if logical <= 0:
            return 0
        ssz, cnt = lsm.stripe_size, lsm.stripe_count
        snum, rem = divmod(logical - 1, ssz)
        r, si = divmod(snum, cnt)         # tail round, tail data index
        p = _r5_parity_slot(lsm, r)
        base = r * ssz
        if s == p:                        # parity = longest data unit
            return base + (rem + 1 if si == 0 else ssz)
        i = s if s < p else s - 1
        if i < si:
            return base + ssz
        if i == si:
            return base + rem + 1
        return base

    def _r5_punch(self, lsm: StripeMd, size: int):
        """Truncate: punch every object to its per-slot size, then
        recompute the (now shorter) tail round's parity.  Best-effort
        on a dead OST — the rebuild regenerates a punched object from
        the post-punch parity anyway."""
        ssz, cnt = lsm.stripe_size, lsm.stripe_count
        for s, o in enumerate(lsm.objects):
            try:
                self.by_uuid[o["ost"]].punch(
                    o["group"], o["oid"], self._r5_obj_size_for(lsm, s, size))
            except R.TimeoutError_:
                self._mark_dead(self.by_uuid[o["ost"]])
                self.sim.stats.count("lov.degraded_punch")
            except R.RpcError:
                self.sim.stats.count("lov.degraded_punch")
        if size <= 0:
            return
        r = (size - 1) // (ssz * cnt)     # tail round
        units = [self._r5_unit_data(lsm, r, i) for i in range(cnt)]
        live = [u for u in units if u]
        if not live:
            return
        parity = ops.parity_bytes(live, device=self.device)
        ps = _r5_parity_slot(lsm, r)
        o = lsm.objects[ps]
        try:
            osc = self.by_uuid[o["ost"]]
            osc.writev(o["group"], o["oid"], [(r * ssz, parity)])
            osc.flush(o["group"], o["oid"])
        except (R.RpcError, R.TimeoutError_):
            self.sim.stats.count("lov.degraded_punch")

    def rebuild_object(self, lsm: StripeMd, dead_uuid: str,
                       spare_osc: osc_mod.Osc) -> Optional[StripeMd]:
        """Regenerate the dead OST's object onto `spare_osc`: reconstruct
        every unit (data AND parity rounds) from the survivors via the
        XOR kernel, write them with ONE vectored BRW, and return the
        swapped StripeMd (caller commits it to the MDS EA under lock).
        Returns None if the file doesn't stripe over `dead_uuid`."""
        dead = next((s for s, o in enumerate(lsm.objects)
                     if o["ost"] == dead_uuid), None)
        if dead is None:
            return None
        ssz = lsm.stripe_size
        grp = lsm.objects[dead]["group"]
        attrs = self._r5_slot_sizes(lsm)
        if any(a is None for s, a in enumerate(attrs) if s != dead):
            raise R.RpcError(-5, "raid5: second OST failure during rebuild")
        sizes = [None if s == dead else a["size"]
                 for s, a in enumerate(attrs)]
        logical = self._r5_degraded_size(lsm, sizes, dead)
        osize = self._r5_obj_size_for(lsm, dead, logical)
        new = spare_osc.create(grp)
        self.by_uuid.setdefault(spare_osc.uuid, spare_osc)
        iov, nb, r = [], 0, 0
        while r * ssz < osize:
            want = min(ssz, osize - r * ssz)
            unit = self._r5_rebuild_slot_unit(lsm, r, dead)[:want]
            unit = unit + b"\0" * (want - len(unit))
            iov.append((r * ssz, unit))
            nb += len(unit)
            r += 1
        if iov:
            spare_osc.writev(grp, new["oid"], iov, lock=False)
            spare_osc.flush(grp, new["oid"])
        self.sim.stats.count("lov.rebuild_object")
        self.sim.stats.count("lov.rebuild_bytes", nb)
        objs = [dict(o) for o in lsm.objects]
        objs[dead] = {"ost": spare_osc.uuid, "group": grp,
                      "oid": new["oid"]}
        return dataclasses.replace(lsm, objects=objs)

    def getattr(self, lsm: StripeMd) -> dict:
        if lsm.pattern == "raid5":
            return self._r5_getattr(lsm, locked=False)
        outs = self.sim.parallel([
            (lambda o=o: self.by_uuid[o["ost"]].getattr(o["group"], o["oid"]))
            for o in lsm.objects])
        return {"size": logical_size(lsm, [a["size"] for a in outs]),
                "mtime": max((a["mtime"] for a in outs), default=0.0),
                "blocks": sum(a["blocks"] for a in outs)}

    def glimpse(self, lsm: StripeMd) -> dict:
        """size/mtime of ONE file via glimpse (§7.7): per-OST vectored
        glimpse_bulk RPCs; writers holding PW locks are asked for their
        LVBs, never revoked — correct even against unflushed write-back
        caches (plain getattr reads disk and misses them)."""
        return self.glimpse_files({0: lsm})[0]

    def glimpse_files(self, lsms: dict) -> dict:
        """Batched glimpse across MANY files: every file's stripe objects
        are grouped per OST and fetched with ONE vectored glimpse_bulk
        RPC per OST (a striped-directory scan pays #OSTs RPCs, not
        #files x #stripes). lsms: key -> StripeMd; returns key ->
        {"size", "mtime"} (logical size recombined per file)."""
        by_ost: dict[str, list] = {}
        for key, lsm in lsms.items():
            for i, o in enumerate(lsm.objects):
                by_ost.setdefault(o["ost"], []).append(
                    (key, i, o["group"], o["oid"]))

        def one(uuid, items):
            osc = self.by_uuid[uuid]
            try:
                outs = osc.glimpse_bulk([(g, o) for _, _, g, o in items])
            except R.TimeoutError_:
                self._mark_dead(osc)
                return []                  # degraded: no witness from it
            except R.RpcError:
                return []
            return [(k, i, a) for (k, i, _, _), a in zip(items, outs)]

        parts = self.sim.parallel([(lambda u=u, it=it: one(u, it))
                                   for u, it in by_ost.items()])
        per_obj: dict[tuple, dict] = {}
        for plist in parts:
            for key, i, a in plist:
                per_obj[(key, i)] = a or {"size": 0, "mtime": 0.0}
        out = {}
        for key, lsm in lsms.items():
            attrs = [per_obj.get((key, i))
                     for i in range(len(lsm.objects))]
            live = [a for a in attrs if a is not None]
            if lsm.pattern == "raid5":
                # best-effort: survivors witness what they can; no
                # reconstruction refinement on the bulk path
                size = _r5_logical_size(
                    lsm, [None if a is None else a["size"] for a in attrs])
            else:
                size = logical_size(
                    lsm, [(a or {"size": 0})["size"] for a in attrs])
            out[key] = {"size": size,
                        "mtime": max((a["mtime"] for a in live),
                                     default=0.0)}
        if self.sim:
            self.sim.stats.count("lov.glimpse")
            self.sim.stats.count("lov.glimpse_files", len(lsms))
        return out

    def getattr_locked(self, lsm: StripeMd) -> dict:
        """getattr under PR locks: revokes writers' PW locks first, so
        their write-back caches flush and the sizes are current (the
        client-side ordering rule of §6.2.3; real Lustre uses glimpse
        ASTs — a PR enqueue is our simpler equivalent). Served from the
        cached locks' value blocks (§7.7) when possible: a warm
        sequential reader pays ZERO RPCs for its size checks."""
        if lsm.pattern == "raid5":
            return self._r5_getattr(lsm, locked=True)
        outs = self.sim.parallel([
            (lambda o=o: self.by_uuid[o["ost"]].getattr_locked(
                o["group"], o["oid"]))
            for o in lsm.objects])
        return {"size": logical_size(lsm, [a["size"] for a in outs]),
                "mtime": max((a["mtime"] for a in outs), default=0.0)}

    def readahead(self, lsm: StripeMd, offset: int, length: int) -> int:
        """Populate the per-OSC clean caches for [offset, offset+length):
        the window is split over the stripe objects and fetched as ONE
        vectored OST_READ per stripe object (runs already cached are
        skipped by the OSC). Returns the number of bytes requested."""
        if lsm.pattern == "raid5":
            return 0                      # no readahead on parity layouts
        runs = _chunks(lsm, offset, length)
        if not runs:
            return 0
        by_stripe: dict[int, list] = {}
        for sidx, obj_off, ln, _ in runs:
            by_stripe.setdefault(sidx, []).append((obj_off, ln))

        def ra(sidx, iov):
            o = lsm.objects[sidx]
            self._osc(lsm, sidx).readv(o["group"], o["oid"], iov)

        self.sim.parallel([(lambda s=s, v=v: ra(s, v))
                           for s, v in by_stripe.items()])
        if self.sim:
            self.sim.stats.count("lov.readahead")
            self.sim.stats.count("lov.readahead_bytes", length)
        return length

    def destroy(self, lsm: StripeMd, cookies: list | None = None):
        r5 = lsm.pattern == "raid5"

        def rm(i, o):
            ck = cookies[i] if cookies else None
            try:
                self.by_uuid[o["ost"]].destroy(o["group"], o["oid"],
                                               cookie=ck)
            except R.RpcError as e:
                # -2: already gone; -19: deactivated dead OST (its
                # objects die with it — rebuild re-created the live copy)
                if e.status not in (-2, -19):
                    raise
            except R.TimeoutError_:
                if not r5:
                    raise
                self._mark_dead(self.by_uuid[o["ost"]])
        self.sim.parallel([(lambda i=i, o=o: rm(i, o))
                           for i, o in enumerate(lsm.objects)])

    def punch(self, lsm: StripeMd, size: int):
        if lsm.pattern == "raid5":
            return self._r5_punch(lsm, size)
        # per-object truncation point
        for i, o in enumerate(lsm.objects):
            osz = self._obj_size_for(lsm, i, size)
            self.by_uuid[o["ost"]].punch(o["group"], o["oid"], osz)

    @staticmethod
    def _obj_size_for(lsm: StripeMd, i: int, logical: int) -> int:
        """Object-local size when the file is truncated to `logical`."""
        if logical == 0:
            return 0
        last = logical - 1
        snum, rem = divmod(last, lsm.stripe_size)
        full_rounds, sidx = divmod(snum, lsm.stripe_count)
        if i < sidx:
            return (full_rounds + 1) * lsm.stripe_size
        if i == sidx:
            return full_rounds * lsm.stripe_size + rem + 1
        return full_rounds * lsm.stripe_size

    def flush(self):
        self.sim.parallel([(lambda o=o: o.flush()) for o in self.oscs])

    def sync(self):
        self.sim.parallel([(lambda o=o: o.sync()) for o in self.oscs])


# ------------------------------------------------------------------ RAID1

class Raid1:
    """Redundant OSTs (ch. 15): mirror writes to two OSCs; reads prefer the
    primary and fail over; a dirty-extent log drives resync after an OST
    comes back.

    Each dirty-log entry records WHICH mirror missed the write — resync
    must copy from the up-to-date mirror to the stale one (reading
    "primary first" would replay stale data over the good copy whenever
    the primary was the mirror that missed), and reads must never be
    served from a mirror with pending dirty extents for the range."""

    def __init__(self, primary: osc_mod.Osc, secondary: osc_mod.Osc,
                 group: int = 0):
        self.a = primary
        self.b = secondary
        self.sim = primary.sim
        self.group = group
        # (oid, off, len, missed) — missed in {"a", "b"}: the STALE side
        self.dirty_log: list[tuple[int, int, int, str]] = []

    def _mirror(self, name: str) -> osc_mod.Osc:
        return self.a if name == "a" else self.b

    def create(self, oid: int | None = None) -> int:
        out = self.a.create(self.group, oid)
        self.b.create(self.group, out["oid"])
        return out["oid"]

    def write(self, oid: int, offset: int, data: bytes):
        def one(osc):
            try:
                osc.write(self.group, oid, offset, data)
                return True
            except (R.RpcError, R.TimeoutError_):
                return False
        oks = self.sim.parallel([lambda: one(self.a), lambda: one(self.b)])
        if not any(oks):
            raise R.RpcError(-5, "both mirrors failed")
        if not all(oks):
            missed = "a" if not oks[0] else "b"
            self.dirty_log.append((oid, offset, len(data), missed))
            self.sim.stats.count("raid1.degraded_write")

    # ------------------------------------------------------ dirty log
    def _dirty_overlap(self, oid: int, off: int, ln: int,
                       mirror: str) -> list:
        """Dirty-log entries marking `mirror` stale over [off, off+ln)."""
        return [e for e in self.dirty_log
                if e[0] == oid and e[3] == mirror
                and e[1] < off + ln and off < e[1] + e[2]]

    def _heal_entries(self, entries: list) -> bool:
        """Copy each entry from its up-to-date mirror onto the stale one;
        on success drop it from the log. False if any copy failed (the
        entries stay logged and the stale mirror stays unserved)."""
        for e in entries:
            oid, off, ln, missed = e
            src = self._mirror("b" if missed == "a" else "a")
            dst = self._mirror(missed)
            try:
                data = src.read(self.group, oid, off, ln)
                dst.write(self.group, oid, off, data)
            except (R.RpcError, R.TimeoutError_):
                return False
            self.dirty_log.remove(e)
            self.sim.stats.count("raid1.heal_on_read")
        return True

    # ----------------------------------------------------------- reads
    def read(self, oid: int, offset: int, length: int) -> bytes:
        """Primary-preferring read that never serves stale bytes: a
        mirror with pending dirty extents overlapping the range is
        healed from the up-to-date mirror first — if healing is
        impossible (the up-to-date side is down) the stale mirror is
        SKIPPED, and -5 beats silently wrong data."""
        for name in ("a", "b"):
            stale = self._dirty_overlap(oid, offset, length, name)
            if stale and not self._heal_entries(stale):
                self.sim.stats.count("raid1.stale_read_avoided")
                continue
            try:
                data = self._mirror(name).read(self.group, oid, offset,
                                               length)
            except (R.RpcError, R.TimeoutError_):
                continue
            if name == "b":
                self.sim.stats.count("raid1.failover_read")
            return data
        raise R.RpcError(-5, "raid1: no mirror holds fresh data")

    def read_hedged(self, oid: int, offset: int, length: int) -> bytes:
        """Straggler mitigation: issue the read to BOTH mirrors, take the
        first completion (a slow/overloaded OST only costs its own link).
        Both racers run; if the winner failed, the LOSER's result is
        used as-is — no third RPC.  Ranges with pending dirty extents
        take the dirty-aware `read()` path instead."""
        if (self._dirty_overlap(oid, offset, length, "a")
                or self._dirty_overlap(oid, offset, length, "b")):
            return self.read(oid, offset, length)
        results: list = [None, None]

        def one(idx, osc):
            try:
                results[idx] = osc.read(self.group, oid, offset, length)
            except (R.RpcError, R.TimeoutError_):
                pass
            return results[idx]

        widx, data = self.sim.race([lambda: one(0, self.a),
                                    lambda: one(1, self.b)])
        if data is None:                  # winner failed: loser already ran
            data = results[1 - widx]
            if data is None:
                raise R.RpcError(-5, "both mirrors failed")
            self.sim.stats.count("raid1.hedge_loser_used")
        return data

    def resync(self):
        """Replay the dirty log: copy each extent FROM the mirror that
        took the write TO the one that missed it (direction recorded at
        write time — reading "primary first" here would overwrite the
        good secondary with stale primary data whenever the primary was
        the side that missed)."""
        log, self.dirty_log = self.dirty_log, []
        healed = 0
        for oid, off, ln, missed in log:
            src = self._mirror("b" if missed == "a" else "a")
            dst = self._mirror(missed)
            try:
                data = src.read(self.group, oid, off, ln)
                dst.write(self.group, oid, off, data)
                healed += 1
            except (R.RpcError, R.TimeoutError_):
                self.dirty_log.append((oid, off, ln, missed))
        return healed
