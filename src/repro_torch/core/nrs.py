"""Network Request Scheduler (NRS): pluggable per-target request ordering.

The paper's service loops (ch. 22-23) drain each request queue strictly
FIFO.  At scale that lets one aggressive client starve everyone sharing an
OST, so production Lustre grew an NRS framework between the request-in
event and the handler.  This module reproduces that layer for our
synchronous simulator.

Because the cluster runs synchronously with an analytic virtual clock,
policies do not physically reorder a queue; they decide *when in virtual
time* the service picks each request up.  `schedule(req, arrival, cost)`
returns the virtual start instant and advances the policy's internal
chains:

  * ``fifo`` — one busy chain: start = max(arrival, busy_until).  Exactly
    the seed service-loop behaviour.
  * ``crr``  — client round-robin via start-time fair queueing: one chain
    per client, each charged cost x n_active (every active client gets a
    1/n share), so a light client's latency is independent of a heavy
    client's backlog.
  * ``orr``  — object round-robin: the same fair chains keyed by
    (group, oid), modelling per-object batched ordering (disk-friendly
    grouping; requests to a cold object never wait behind a hot one).
  * ``orr_disk`` — disk-locality ORR: the ``orr`` chains plus a
    contiguity-aware charge — a BRW continuing exactly where the
    object's last one ended is batched with it (the seek component of
    the seek-aware cost model is refunded), so queues batch by on-disk
    contiguity, not just by object.
  * ``wfq``  — weighted fair queueing: the CRR chains with per-export
    weights (a weight-3 client gets 3x the share of a weight-1 client
    under contention); installed with
    ``lctl("nrs", uuid, "wfq", {"weights": {...}})``.
  * ``tbf``  — token bucket filter QoS: per-class buckets (class = the
    request's jobid when a ``rules`` entry matches it, else the client
    uuid) delay a request's start until a token is available, enforcing
    requests/sec rate limits per tenant or per batch job.
  * ``tbf_orr`` — two-level composition: TBF admission (rate limits for
    classes named in ``rules``; everyone else unlimited) feeding the
    ``orr_disk`` ordering — QoS and disk locality compose, which is how
    raid5 OST rebuild traffic is throttled without starving clients.

Every policy keeps request accounting (per-client and per-object counts,
total queue wait) exposed through ``info()`` — the substrate for the
fairness/observability work Brim et al. and Doreau motivate — surfaced in
``LustreCluster.procfs()["targets"][uuid]["nrs"]``.
"""
from __future__ import annotations

from collections import defaultdict

# Control-plane ops are never throttled or fair-queued: delaying a
# connect/ping turns QoS into a recovery hazard.
CONTROL_OPS = {"connect", "disconnect", "ping"}


class NrsPolicy:
    """Base policy: accounting + the FIFO busy chain helpers."""

    name = "fifo"

    def __init__(self, sim, **params):
        self.sim = sim
        self.params = dict(params)
        self.busy_until = 0.0
        self.n_reqs = 0
        self.total_wait = 0.0
        self.per_client = defaultdict(int)
        self.per_client_wait = defaultdict(float)
        self.per_jobid = defaultdict(int)
        self.per_object = defaultdict(int)

    # ------------------------------------------------------------ schedule
    def schedule(self, req, arrival: float, cost: float) -> float:
        """Return the virtual-time start for `req` arriving at `arrival`
        whose handler occupies the service for `cost` seconds."""
        raise NotImplementedError

    # ---------------------------------------------------------- accounting
    def _account(self, req, arrival: float, start: float):
        self.n_reqs += 1
        wait = max(0.0, start - arrival)
        self.total_wait += wait
        self.per_client[req.client_uuid] += 1
        self.per_client_wait[req.client_uuid] += wait
        jobid = getattr(req, "jobid", "")
        if jobid:
            self.per_jobid[jobid] += 1
        oid = req.body.get("oid")
        if oid is not None:
            self.per_object[(req.body.get("group", 0), oid)] += 1

    def info(self) -> dict:
        return {
            "policy": self.name,
            "reqs": self.n_reqs,
            "clients": len(self.per_client),
            "objects": len(self.per_object),
            "total_queue_wait_s": round(self.total_wait, 6),
            "avg_queue_wait_us": round(
                1e6 * self.total_wait / self.n_reqs, 3) if self.n_reqs else 0.0,
            "per_client": dict(self.per_client),
            # per-export breakdown (procfs: one row per client uuid)
            "per_export": {
                u: {"reqs": n,
                    "queue_wait_s": round(self.per_client_wait[u], 6),
                    "avg_queue_wait_us": round(
                        1e6 * self.per_client_wait[u] / n, 3)}
                for u, n in self.per_client.items()},
            "per_jobid": dict(self.per_jobid),
        }


class FifoPolicy(NrsPolicy):
    """Strict arrival order — the seed's implicit policy."""

    name = "fifo"

    def schedule(self, req, arrival, cost):
        start = max(arrival, self.busy_until)
        self.busy_until = start + cost
        self._account(req, arrival, start)
        return start


class RoundRobinPolicy(NrsPolicy):
    """Client round-robin (CRR): start-time fair queueing across clients.

    Each class keeps its own busy chain; a request starts at
    max(arrival, own chain) and extends the chain by cost x n_active, so
    n concurrently active classes each see ~1/n of the service rate and
    none waits behind another's backlog.
    """

    name = "crr"

    def __init__(self, sim, **params):
        super().__init__(sim, **params)
        self.chains: dict = {}

    def classify(self, req):
        return req.client_uuid

    def _stretch(self, active: set, key) -> float:
        """Chain-extension multiplier — the class's inverse service
        share among the currently active classes. CRR: everyone equal."""
        return float(len(active))

    def schedule(self, req, arrival, cost):
        if req.opcode in CONTROL_OPS:
            self._account(req, arrival, arrival)
            return arrival
        key = self.classify(req)
        # chains still running at this arrival are the active sharers
        active = {k for k, t in self.chains.items() if t > arrival}
        active.add(key)
        start = max(arrival, self.chains.get(key, 0.0))
        self.chains[key] = start + cost * self._stretch(active, key)
        self.busy_until = max(self.busy_until, self.chains[key])
        self._account(req, arrival, start)
        return start


class OrrPolicy(RoundRobinPolicy):
    """Object round-robin (ORR): fair chains keyed by (group, oid), so
    requests batch per object; a cold object is served immediately even
    while a hot object has a deep backlog."""

    name = "orr"

    def __init__(self, sim, **params):
        super().__init__(sim, **params)
        self._last_key = None
        self.batch_switches = 0

    def classify(self, req):
        oid = req.body.get("oid")
        if oid is None:
            return ("client", req.client_uuid)
        key = ("obj", req.body.get("group", 0), oid)
        if key != self._last_key:
            self.batch_switches += 1
            self._last_key = key
        return key

    def info(self):
        out = super().info()
        out["batch_switches"] = self.batch_switches
        out["per_object"] = {f"{g}:{o}": n
                             for (g, o), n in self.per_object.items()}
        return out


class OrrDiskPolicy(OrrPolicy):
    """Disk-locality ORR: the per-object fair chains of ``orr`` plus a
    contiguity-aware charge consuming the seek-aware cost model (the
    ROADMAP follow-up to the cost rework).

    ``Service.request_cost`` charges every BRW one head seek per
    discontiguous run. When a queued BRW *continues exactly where the
    object's previously scheduled BRW ended*, the head is already there:
    this policy batches the two — the chain is extended by the transfer
    cost only, the seek component is refunded. A discontiguous request
    (or one against a different object) pays the full seek-inclusive
    cost, so streams are batched by on-disk contiguity, not merely by
    object identity. ``info()["seeks_saved"]`` counts the refunds.

    params:
      seek_cost — the refund per batched contiguous continuation; keep it
                  equal to the Service's seek_cost (default 4e-5 s).
    """

    name = "orr_disk"

    def __init__(self, sim, seek_cost: float = 4e-5, **params):
        super().__init__(sim, **params)
        self.seek_cost = float(seek_cost)
        self._next_off: dict = {}      # object key -> expected next offset
        self.seeks_saved = 0

    @staticmethod
    def _span(req) -> tuple | None:
        """(start, end) of the request's on-disk footprint, if any."""
        b = req.body
        nio = b.get("niobufs")
        if isinstance(nio, (list, tuple)) and nio:
            def ln(n):
                d = n.get("data")
                return len(d) if d is not None else n.get("length", 0)
            return (min(n.get("offset", 0) for n in nio),
                    max(n.get("offset", 0) + ln(n) for n in nio))
        if "offset" in b and ("data" in b or "length" in b):
            ln = len(b["data"]) if b.get("data") is not None \
                else b.get("length", 0)
            return (b["offset"], b["offset"] + ln)
        return None

    def schedule(self, req, arrival, cost):
        if req.opcode not in CONTROL_OPS:
            key = self.classify(req)
            span = self._span(req)
            if span is not None:
                if self._next_off.get(key) == span[0]:
                    # contiguous continuation: batched with the previous
                    # BRW — no head seek between them
                    cost = max(0.0, cost - self.seek_cost)
                    self.seeks_saved += 1
                self._next_off[key] = span[1]
        return super().schedule(req, arrival, cost)

    def info(self):
        out = super().info()
        out["seeks_saved"] = self.seeks_saved
        out["seek_cost"] = self.seek_cost
        return out


class WfqPolicy(RoundRobinPolicy):
    """Weighted fair queueing (WFQ): CRR generalized with per-export
    weights.

    The CRR chains with a weighted stretch: a request extends its class
    chain by ``cost * total_active_weight / own_weight``, so n
    concurrently active classes share the service rate in proportion to
    their weights (CRR is the all-weights-equal special case). Installed
    per target with ``lctl("nrs", uuid, "wfq", {"weights":
    {client_uuid: w}, "default_weight": 1.0})``.

    params:
      weights        — {class: weight}; a class is a jobid or client uuid
      default_weight — weight for classes without an entry (default 1.0)
      by_jobid       — classify EVERY tagged request by its jobid, not
                       just those with a weights entry (default False)
    """

    name = "wfq"

    def __init__(self, sim, weights: dict | None = None,
                 default_weight: float = 1.0, by_jobid: bool = False,
                 **params):
        super().__init__(sim, **params)
        self.weights = {k: float(v) for k, v in (weights or {}).items()}
        self.default_weight = float(default_weight)
        self.by_jobid = bool(by_jobid)

    def classify(self, req):
        """WFQ classes are per-JOBID when the request carries one and
        either a weights entry names that jobid or ``by_jobid`` is set:
        two batch jobs multiplexed over ONE client uuid get their own
        fair shares, and one job spread over many clients drains a
        single weighted class (mirroring the TBF jobid-rule semantics)."""
        jobid = getattr(req, "jobid", "")
        if jobid and (self.by_jobid or jobid in self.weights):
            return jobid
        return req.client_uuid

    def weight_for(self, key) -> float:
        return max(1e-9, self.weights.get(key, self.default_weight))

    def _stretch(self, active, key):
        return sum(self.weight_for(k) for k in active) \
            / self.weight_for(key)

    def info(self):
        out = super().info()
        out["weights"] = dict(self.weights)
        out["default_weight"] = self.default_weight
        out["by_jobid"] = self.by_jobid
        return out


class TbfPolicy(NrsPolicy):
    """Token Bucket Filter QoS: rate-limit request starts per class.

    params:
      rate  — default tokens/sec for every class (1 token per request)
      burst — bucket depth (allows short bursts at line rate)
      rules — {class: rate} overrides, matched against the request's
              jobid first, then its client uuid. A jobid rule makes every
              client running under that batch-job tag share ONE bucket
              (the production "throttle this job, whoever runs it" knob).
    """

    name = "tbf"

    def __init__(self, sim, rate: float = 1000.0, burst: float = 4.0,
                 rules: dict | None = None, **params):
        super().__init__(sim, **params)
        self.rate = float(rate)
        self.burst = float(burst)
        self.rules = dict(rules or {})
        # class -> (tokens, last_update_time)
        self.buckets: dict = {}
        self.throttled = 0

    def rate_for(self, key) -> float:
        return float(self.rules.get(key, self.rate))

    def classify(self, req):
        """TBF class: a matching jobid rule wins over the client uuid, so
        all clients of one batch job drain a single shared bucket."""
        jobid = getattr(req, "jobid", "")
        if jobid and jobid in self.rules:
            return jobid
        return req.client_uuid

    def schedule(self, req, arrival, cost):
        if req.opcode in CONTROL_OPS:
            self._account(req, arrival, arrival)
            return arrival
        key = self.classify(req)
        rate = max(1e-9, self.rate_for(key))
        tokens, last = self.buckets.get(key, (self.burst, arrival))
        # refill up to the arrival instant (clock may rewind between
        # parallel thunks — never refill backwards)
        now = max(arrival, last)
        tokens = min(self.burst, tokens + (now - last) * rate)
        if tokens >= 1.0:
            token_ready = now
        else:
            token_ready = now + (1.0 - tokens) / rate
            self.throttled += 1
        svc_free = max(arrival, self.busy_until)
        start = max(svc_free, token_ready)
        # spend the token at `start` (refill any wait time first)
        tokens = min(self.burst, tokens + (start - now) * rate) - 1.0
        self.buckets[key] = (tokens, start)
        # the busy chain advances by service occupancy only: while a
        # throttled class idles waiting for tokens, other classes run —
        # one tenant's rate limit must not head-of-line-block the rest
        self.busy_until = svc_free + cost
        self._account(req, arrival, start)
        return start

    def info(self):
        out = super().info()
        out["rate"] = self.rate
        out["burst"] = self.burst
        out["rules"] = dict(self.rules)
        out["throttled"] = self.throttled
        return out


class TbfOrrPolicy(OrrDiskPolicy):
    """Two-level policy (the ROADMAP'd composition): TBF rate limits
    OVER orr_disk ordering, so QoS and disk locality compose instead of
    being either/or.

    Level 1 (admission): a token bucket per QoS class (jobid-rule first,
    else client uuid — the TBF semantics) delays the request's effective
    arrival until a token is free.  Level 2 (ordering): the admitted
    request then takes the ordinary ``orr_disk`` path — per-object fair
    chains with the contiguous-continuation seek refund.

    This is what OST rebuild wants: the rebuilder runs under a
    ``rules={"rebuild": r}`` bucket so its reconstruction BRWs trickle
    in at r req/s and client p99 holds, while WITHIN its trickle the
    requests still batch by object and disk contiguity (a throttled
    rebuild that also seeks randomly would waste its whole budget).

    params:
      rate  — default tokens/sec per class; 0 = unlimited (default —
              only classes named in ``rules`` are throttled)
      burst — bucket depth (default 4)
      rules — {class: rate} overrides, jobid first then client uuid
      seek_cost — forwarded to orr_disk
    """

    name = "tbf_orr"

    def __init__(self, sim, rate: float = 0.0, burst: float = 4.0,
                 rules: dict | None = None, **params):
        super().__init__(sim, **params)
        self.rate = float(rate)
        self.burst = float(burst)
        self.rules = dict(rules or {})
        self.buckets: dict = {}        # class -> (tokens, last_update)
        self.throttled = 0
        # ORR chain keys whose traffic is token-limited: they YIELD in
        # the fair-share stretch (see _stretch)
        self._throttled_keys: set = set()

    def rate_for(self, key) -> float:
        return float(self.rules.get(key, self.rate))

    def tbf_classify(self, req):
        jobid = getattr(req, "jobid", "")
        if jobid and jobid in self.rules:
            return jobid
        return req.client_uuid

    def _admit(self, req, arrival: float) -> float:
        """Token release instant for the request's QoS class."""
        key = self.tbf_classify(req)
        rate = self.rate_for(key)
        if rate <= 0:
            return arrival             # unlimited class
        tokens, last = self.buckets.get(key, (self.burst, arrival))
        now = max(arrival, last)       # clock may rewind between thunks
        tokens = min(self.burst, tokens + (now - last) * rate)
        if tokens >= 1.0:
            ready = now
        else:
            ready = now + (1.0 - tokens) / rate
            self.throttled += 1
        tokens = min(self.burst, tokens + (ready - now) * rate) - 1.0
        self.buckets[key] = (tokens, ready)
        return ready

    def _stretch(self, active, key):
        """Throttled classes yield: the token bucket IS their service
        allocation, so their paced chains must not also count as fair-
        share members — otherwise a rebuild spread over many objects
        would claim one share per object ON TOP of its rate cap and
        unthrottled clients would see 1/n service during the whole
        rebuild window (the exact starvation the composition exists to
        prevent). A throttled class itself still shares with everything
        active; unthrottled classes share only with each other."""
        if key in self._throttled_keys:
            return float(len(active))
        return float(max(1, sum(1 for k in active
                                if k not in self._throttled_keys)))

    def schedule(self, req, arrival, cost):
        if req.opcode in CONTROL_OPS:
            self._account(req, arrival, arrival)
            return arrival
        if self.rate_for(self.tbf_classify(req)) > 0:
            # mirror of classify()'s key, without its batch accounting
            oid = req.body.get("oid")
            self._throttled_keys.add(
                ("client", req.client_uuid) if oid is None
                else ("obj", req.body.get("group", 0), oid))
        # admission first, ordering second: the orr_disk chains see the
        # token-release instant as the arrival
        return super().schedule(req, max(arrival, self._admit(req, arrival)),
                                cost)

    def info(self):
        out = super().info()
        out["rate"] = self.rate
        out["burst"] = self.burst
        out["rules"] = dict(self.rules)
        out["throttled"] = self.throttled
        return out


POLICIES = {p.name: p for p in
            (FifoPolicy, RoundRobinPolicy, OrrPolicy, OrrDiskPolicy,
             WfqPolicy, TbfPolicy, TbfOrrPolicy)}


def make_policy(name: str, sim, **params) -> NrsPolicy:
    cls = POLICIES.get(name)
    if cls is None:
        raise ValueError(f"unknown NRS policy {name!r} "
                         f"(have: {sorted(POLICIES)})")
    return cls(sim, **params)
