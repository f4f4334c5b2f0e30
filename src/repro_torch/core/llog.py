"""Lustre logging API — llog (paper ch. 8).

Write-ahead *intent* logs with catalogs and a cross-node cancellation
protocol. Used by:
  * MDS unlink -> OST object destroy (orphan recovery): the MDS logs an
    "unlink" record per data object; the OST cancels the cookie once the
    destroy is committed; after a crash, uncancelled records are re-shipped
    (ch. 8.4, §6.7.5);
  * size/mtime recovery (ch. 8.10);
  * configuration logs (ch. 8.9).

Records live in the owning target's persistent state and participate in its
transaction/undo machinery via the caller.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable

from repro_torch.core import fail as fail_mod


_cookie_seq = itertools.count(1)


@dataclasses.dataclass
class LlogRecord:
    idx: int
    rec_type: str
    payload: dict
    cookie: int = dataclasses.field(default_factory=lambda: next(_cookie_seq))
    cancelled: bool = False


class LlogHandle:
    """One plain log (a special object on the backing store)."""

    def __init__(self, logid: str, cap: int | None = None):
        self.logid = logid
        self.cap = cap
        self.records: list[LlogRecord] = []
        self.added = 0               # index slots ever consumed (cancelling
        self._idx = itertools.count(1)   # a record does not free its slot)

    def add(self, rec_type: str, payload: dict) -> LlogRecord:
        rec = LlogRecord(next(self._idx), rec_type, payload)
        self.records.append(rec)
        self.added += 1
        return rec

    def full(self) -> bool:
        return self.cap is not None and self.added >= self.cap

    def cancel(self, cookies) -> int:
        """Cancel by cookie set; full logs get destroyed by the catalog."""
        cs = set(cookies)
        n = 0
        for r in self.records:
            if r.cookie in cs and not r.cancelled:
                r.cancelled = True
                n += 1
        self.records = [r for r in self.records if not r.cancelled]
        return n

    def pending(self) -> list[LlogRecord]:
        return [r for r in self.records if not r.cancelled]

    def empty(self) -> bool:
        return not self.records


class LlogCatalog:
    """Catalog of llog handles (ch. 8.3: catalog + plain logs)."""

    LOG_CAP = 64                      # records per plain log

    def __init__(self, name: str):
        self.name = name
        self.logs: list[LlogHandle] = []
        self._seq = itertools.count(1)

    def _current(self) -> LlogHandle:
        if not self.logs or self.logs[-1].full():
            self.logs.append(LlogHandle(f"{self.name}-{next(self._seq)}",
                                        cap=self.LOG_CAP))
        return self.logs[-1]

    def add(self, rec_type: str, payload: dict) -> LlogRecord:
        rec = self._current().add(rec_type, payload)
        # deferred crash site: the induced crash lands at the owning
        # target's request boundary — journal atomicity means a crash can
        # never expose half the transaction this write belongs to
        fail_mod.note("llog.catalog.add")
        return rec

    def restore(self, recs) -> None:
        """Undo of a cancel (transaction rollback): re-insert previously
        cancelled records with their original cookies/payloads. Appended
        to the current plain log — readers that need index order must
        sort (the changelog does)."""
        for rec in recs:
            rec.cancelled = False
            lg = self._current()
            lg.records.append(rec)
            lg.added += 1

    def cancel(self, cookies) -> int:
        # deferred crash site: cancellation is part of the surrounding
        # transaction (destroy / changelog clear) — a crash lands at the
        # owning target's request boundary and the undo log re-inserts
        # the records, which are then re-shipped and re-cancelled
        fail_mod.note("llog.cancel")
        n = 0
        for lg in list(self.logs):
            n += lg.cancel(cookies)
            # destroy drained logs. A FULL log is dead even when it is the
            # current (last) one: its index slots are consumed, so the next
            # add() rotates to a fresh log anyway — keeping it alive leaked
            # one plain-log object per drained catalog tail.
            if lg.empty() and (lg.full() or lg is not self.logs[-1]):
                self.logs.remove(lg)
        return n

    def pending(self) -> list[LlogRecord]:
        return [r for lg in self.logs for r in lg.pending()]

    def process(self, cb: Callable[[LlogRecord], bool]) -> int:
        """Run `cb` over pending records; records for which cb returns True
        are cancelled (llog_process + cancel, ch. 8.7). Returns #cancelled."""
        done = []
        for rec in self.pending():
            if cb(rec):
                done.append(rec.cookie)
        return self.cancel(done)
