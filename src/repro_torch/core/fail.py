"""OBD_FAIL-style failpoint registry (crash-point testing, ch. 11).

Real Lustre proves its recovery claims with ``OBD_FAIL_CHECK(id)`` sites
compiled into every interesting code path and a global ``fail_loc``
(set via ``lctl set_param fail_loc=...``) that arms exactly one of them;
the recovery test matrix then crashes a target at *every* site and
asserts the cluster heals.  This module reproduces that machinery for
the simulator:

  * **Sites** are registered by name at import time (``register_site``);
    ``SITES`` is the authoritative map the crash-point sweep in
    ``tests/test_recovery.py`` parametrizes over.
  * ``fail_loc`` / ``fail_val`` are armed via
    ``cluster.lctl("set_param", "fail_loc", site[, nth])``:
    the site triggers on its ``nth`` hit (default: first), once
    (OBD_FAIL_ONCE semantics), then disarms itself.
  * A triggered site raises :class:`FailLocHit`.  ``ptlrpc.Node``
    catches it at the request boundary and powers the serving target
    off at that exact point: uncommitted state is lost through the undo
    log, the in-flight request is dropped (no reply), and the client
    recovers through the normal timeout -> reconnect -> replay path.

Two site flavours:

  * ``maybe_fail(site)`` — *immediate*: raises right at the call site.
    Placed only where the target's state is transaction-consistent
    (request boundaries, reint entry, commit edges), because the crash
    rollback can only undo *registered* transactions.
  * ``note(site)`` — *deferred*: arms a pending crash that
    ``raise_if_pending(owner)`` fires at the owning target's next
    request boundary.  Used for sites *inside* a mutation (llog writes,
    changelog emits, backend transactions): a journaled filesystem
    cannot expose half a transaction after a crash, so the induced
    crash lands at the transaction boundary — the llog write is what
    arms it, the whole uncommitted transaction is what dies.

Like real Lustre's ``obd_fail_loc`` the armed state is node-global
(module-global here); every fresh :class:`repro_torch.core.sim.Simulator`
resets it so clusters are isolated from one another.

Contract: the crash/restart handling lives at the ptlrpc request
boundary, so arm sites only for RPC-driven flows. A site hit OUTSIDE
any request context (e.g. arming ``mds.txn`` and then mutating a target
directly through ``lctl`` verbs) raises :class:`FailLocHit` straight
into the caller — deliberate, so a mis-armed test fails loudly instead
of silently skipping the crash — but nothing rolls the target back.
"""
from __future__ import annotations

from collections import defaultdict

# --------------------------------------------------------------- registry

SITES: dict[str, str] = {}       # site name -> description


def register_site(name: str, desc: str) -> str:
    SITES[name] = desc
    return name


class FailLocHit(Exception):
    """An armed failpoint fired: the caller's target must crash here."""

    def __init__(self, site: str):
        super().__init__(f"fail_loc hit: {site}")
        self.site = site


class FailLocDrop(Exception):
    """An armed failpoint fired with the 'drop' action: the in-flight
    request is lost on the wire (OBD_FAIL_*_NET semantics) — the target
    stays up, no reply is sent, the client recovers by timeout+resend."""

    def __init__(self, site: str):
        super().__init__(f"fail_loc drop: {site}")
        self.site = site


ACTIONS = ("crash", "drop", "delay")


class FailState:
    """The armed failpoint (one at a time, like obd_fail_loc).

    Besides the classic crash, a site can be armed with an *action*:

      * ``crash`` — power the serving target off at the site (default);
      * ``drop``  — lose the in-flight message instead (OBD_FAIL_*_NET):
        server sites drop the request/reply, the DLM blocking-AST site
        loses the AST (holder presumed dead -> evicted), the client-side
        ``osc.flush`` site loses the flush's first BRW RPC on the wire;
      * ``delay`` — stall the site for ``fail_delay`` virtual seconds
        (slow disk / slow wire), then continue normally.
    """

    def __init__(self):
        self.loc = ""                    # armed site name ("" = disarmed)
        self.val = 1                     # trigger on the val-th hit
        self.action = "crash"            # what a triggered site does
        self.delay_s = 0.25              # 'delay' action stall (virtual s)
        self.sim = None                  # owning Simulator (delay needs it)
        self.hits = defaultdict(int)     # site -> times checked while armed
        self.fired = 0                   # total failures induced
        # deferred-crash bookkeeping: the innermost target currently
        # processing a request (see ptlrpc.Node._request_in) owns any
        # pending crash armed by a note() inside its handler.
        self.service_stack: list = []
        self.pending: dict = {}          # owner id -> (site, action)

    # ------------------------------------------------------------- control
    def arm(self, loc: str, val: int | None = None,
            action: str | None = None):
        """Arm `loc`; `val` = fire on the val-th hit. Like real Lustre,
        fail_val and fail_loc are order-independent: arming without an
        explicit val/action keeps whatever was set before."""
        if loc and loc not in SITES:
            raise ValueError(f"unknown fail site {loc!r} "
                             f"(have: {sorted(SITES)})")
        self.loc = loc
        if val is not None:
            self.val = max(1, int(val))
        if action is not None:
            if action not in ACTIONS:
                raise ValueError(f"unknown fail action {action!r} "
                                 f"(have: {ACTIONS})")
            self.action = action

    def disarm(self):
        self.loc = ""

    def reset(self):
        self.disarm()
        self.val = 1
        self.action = "crash"
        self.delay_s = 0.25
        self.hits.clear()
        self.fired = 0
        self.service_stack.clear()
        self.pending.clear()

    # -------------------------------------------------------------- checks
    def _triggered(self, site: str) -> bool:
        if site != self.loc:
            return False
        self.hits[site] += 1
        if self.hits[site] < self.val:
            return False
        self.disarm()                    # OBD_FAIL_ONCE: one shot
        self.fired += 1
        return True

    def _delay(self):
        if self.sim is not None:
            self.sim.clock.advance(self.delay_s)

    def maybe_fail(self, site: str):
        """Immediate site: act right here (crash raises at a
        transaction-consistent point; drop loses the in-flight request;
        delay stalls and continues)."""
        if not self._triggered(site):
            return
        if self.action == "delay":
            self._delay()
        elif self.action == "drop":
            raise FailLocDrop(site)
        else:
            raise FailLocHit(site)

    def note(self, site: str):
        """Deferred site: the crash/drop lands at the owning target's
        request boundary (transaction atomicity — see module docstring);
        a delay stalls immediately (it breaks no atomicity)."""
        if not self._triggered(site):
            return
        if self.action == "delay":
            self._delay()
        elif self.service_stack:
            self.pending[id(self.service_stack[-1])] = (site, self.action)
        else:                            # no request context: fail now
            raise FailLocHit(site)

    def check(self, site: str) -> str | None:
        """Self-interpreting site: returns the armed action if `site`
        triggers (handling 'delay' in place), else None. Call sites with
        their own drop/crash semantics (dlm.blocking_ast, osc.flush)
        dispatch on the result."""
        if not self._triggered(site):
            return None
        if self.action == "delay":
            self._delay()
        return self.action

    def defer(self, site: str):
        """Arm a pending crash for the innermost serving target (used by
        check() call sites that want crash-at-request-boundary)."""
        if self.service_stack:
            self.pending[id(self.service_stack[-1])] = (site, "crash")
        else:
            raise FailLocHit(site)

    # ----------------------------------------------- request-boundary hooks
    def enter_service(self, owner):
        self.service_stack.append(owner)

    def exit_service(self, owner):
        if self.service_stack and self.service_stack[-1] is owner:
            self.service_stack.pop()

    def raise_if_pending(self, owner):
        hit = self.pending.pop(id(owner), None)
        if hit is not None:
            site, action = hit
            if action == "drop":
                raise FailLocDrop(site)
            raise FailLocHit(site)

    def info(self) -> dict:
        return {"fail_loc": self.loc, "fail_val": self.val,
                "fail_action": self.action, "fail_delay": self.delay_s,
                "fired": self.fired, "hits": dict(self.hits)}


# One node-global armed state, exactly like obd_fail_loc; Simulator's
# constructor calls reset() so each cluster starts disarmed.
state = FailState()

maybe_fail = state.maybe_fail
note = state.note


# ---------------------------------------------------- the registered sites
# ptlrpc request boundaries (crash before executing / before replying):
register_site("ptlrpc.mds.request_in",
              "MDS request received, nothing executed yet")
register_site("ptlrpc.ost.request_in",
              "OST request received, nothing executed yet")
register_site("ptlrpc.mds.before_reply",
              "MDS handler done (txns registered), reply not sent")
register_site("ptlrpc.ost.before_reply",
              "OST handler done (txns registered), reply not sent")
# MDS reint / commit path:
register_site("mds.reint.before", "reint dispatched, before any mutation")
register_site("mds.commit.before", "MDS journal flush about to start")
register_site("mds.commit.after",
              "MDS journal flush durable, reply lost (deferred)")
register_site("mds.txn", "inside an MDS metadata transaction (deferred)")
# OST transactions / commit:
register_site("ost.commit.before", "OST journal flush about to start")
register_site("ost.commit.after",
              "OST journal flush durable, reply lost (deferred)")
register_site("ost.txn", "inside an OST backend transaction (deferred)")
# llog / changelog writes:
register_site("llog.catalog.add", "llog record appended (deferred)")
register_site("mds.changelog.emit", "changelog record emitted (deferred)")
register_site("mds.changelog.clear",
              "changelog_clear dispatched, before bookmark/purge")
register_site("mds.changelog.clear.applied",
              "bookmark+purge transaction applied, not yet committed")
# DLM blocking-AST path / OSC write-back flush:
register_site("dlm.blocking_ast",
              "server about to send a blocking AST to a lock holder "
              "(drop: AST lost -> holder evicted; crash: deferred to the "
              "triggering request's boundary)")
register_site("osc.flush",
              "client write-back flush about to ship its BRW vectors "
              "(client-side site: crash degrades to drop — the flush's "
              "first RPC is lost on the wire and the import recovers by "
              "timeout -> reconnect -> resend)")
# Statahead prefetch:
register_site("mds.statahead",
              "client statahead about to ship its batched getattr_bulk/"
              "glimpse prefetch (client-side site: crash degrades to "
              "drop — the prefetch is abandoned and every stat falls "
              "back to a correct synchronous fetch)")
# Metadata writeback cache reintegration:
register_site("mdc.wbc_flush",
              "client WBC about to ship a reint_batch flush "
              "(client-side site: crash degrades to drop — the batch "
              "RPC is lost on the wire and the import recovers by "
              "timeout -> reconnect -> resend, so the flush still "
              "completes; the unsent tail stays cached)")
register_site("mds.reint_batch",
              "inside op_reint_batch, before applying the next record "
              "(the batch is ONE undo-scoped transaction: a crash here "
              "unwinds every already-applied record and client replay "
              "re-applies the batch exactly once)")
# Monitoring plane + grant/llog maintenance:
register_site("mon.collect",
              "target about to assemble its mon_collect leaf (crash/"
              "drop: the collector's single-attempt RPC times out and "
              "the snapshot degrades to a PARTIAL one with this target "
              "marked stale — never a hang, never a wrong total)")
register_site("llog.cancel",
              "llog catalog cancelling cookies (deferred: the crash "
              "lands at the owning target's request boundary, the whole "
              "uncommitted cancel transaction dies and the records are "
              "re-shipped/re-cancelled after recovery — cancel is "
              "idempotent)")
register_site("osc.grant_shrink",
              "client about to return idle grant to the OST (client-"
              "side site: crash degrades to drop — the shrink RPC is "
              "lost on the wire and the import recovers by timeout -> "
              "reconnect -> resend; the absolute 'keep' target makes "
              "the retry idempotent)")
# raid5 OST rebuild:
register_site("lov.rebuild",
              "rebuilder about to reconstruct one file's dead-slot "
              "object onto the spare (client-side site: crash degrades "
              "to abort — the rebuild stops mid-namespace-walk; no "
              "layout was touched yet, every file it skipped still "
              "serves degraded reads from parity and a rerun finishes "
              "the job)")
# recovery-robustness plane:
register_site("ptl.early_reply",
              "service about to grant an adaptive-timeout early reply "
              "extending the client's deadline (drop: the reply — and "
              "the extension riding on it — is lost on the wire, the "
              "client declares a spurious timeout and heals by resend "
              "-> reply cache; crash: the target dies after executing "
              "but before replying, the client reconnects and replays)")
register_site("mds.recovery_window",
              "MDS about to close its recovery window (VBR: stragglers "
              "are NOT blanket-evicted — a late replay is admitted iff "
              "its pre-op versions still match; crash here restarts "
              "recovery from the journal, drop loses the close and the "
              "window closes again at the next trigger)")
register_site("ping.notify",
              "pinger noticed a target reboot and is about to trigger "
              "imperative recovery (self-interpreting: drop/crash lose "
              "the notification — the client falls back to the timeout-"
              "driven reconnect path, strictly slower but safe)")
register_site("net.flap",
              "chaos harness about to power-cycle a server node (self-"
              "interpreting: drop/crash suppress the flap — the "
              "schedule skips the event and the workload proceeds on a "
              "healthy fabric)")
register_site("lov.layout_swap",
              "rebuilder about to commit a rebuilt file's new StripeMd "
              "to the MDS EA (client-side site: crash degrades to "
              "abort BEFORE the setattr — the old layout stays intact "
              "and degraded-readable, the spare object is merely "
              "orphaned; readers never observe a torn layout)")
