"""Card harvesting: the serving fleet borrows idle notebook cards (the
port's copy of ``kubeflow_rm_tpu/controlplane/harvest.py``; its leases
are charges of ``nvidia.com/gpu`` in the scheduler cache, its replicas
the port's ``webapps/serving.ServingGateway`` behind
``serving_fleet.ServingFleet``, and its Event messages keep JAX's
words, "chip" included, so the two object graphs stay equal).

The platform's two big consumers pull in opposite directions on the
same pool: notebooks hold slices interactively (bursty, latency-
sensitive, suspend/resume makes them *elastic donors*), while the
serving fleet wants every chip it can get the moment decode queues
deepen. r13-r18 built each side separately; this module closes the
loop — a :class:`ChipHarvestController` watches serving pressure (the
r12 SLO burn engine + decode queue depth) and, when it sustains,
*harvests*: it parks an idle notebook through the exact
checkpoint→drain→release lifecycle idle culling uses, binds a serving
replica gang onto the freed slice, and registers the replica with the
fleet.

The contract that makes this safe to run against interactive users:

- **Notebook demand ALWAYS outranks harvested serving.** Every chip a
  harvest gang holds is charged in the scheduler cache with a
  ``harvested`` mark, and the cache exposes ``reclaim_harvested`` —
  the FIRST thing ``suspend.try_preempt`` tries when any gang fails to
  bind. A resuming donor (or any other notebook that needs chips)
  drains the serving replica, migrates its in-flight requests to the
  rest of the fleet (the GlobalBlockStore keeps the prefix blocks, so
  continuations stay bit-exact), and re-gangs on the returned slice —
  inside the same reconcile that failed to bind.
- **No pinned or culling-excluded notebook is ever harvested**, and a
  running notebook must sit idle past a threshold before it is a
  donor; already-Suspended notebooks are preferred (their chips are
  free — harvesting them suspends nobody).
- **Harvest gangs prefer whole freed slices** (``prefer_whole_nodes``)
  so a reclaim returns an intact slice instead of scattering the
  donor's re-bind across fragmented remainders.
- **Give-back is autonomous**: sustained calm (no burn, shallow
  queues) returns the oldest lease without waiting for demand.

Harvest charges are *synthetic*: no apiserver pods back them (the
serving fleet is not a Kubernetes workload here), so they live as
assumed entries in the scheduler cache — ``rebuild()`` preserves
assumed entries precisely so a relist cannot wipe a lease and
double-book the chips.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock
from kubeflow_rm_tpu_torch.controlplane import metrics, scheduler, suspend
from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
from kubeflow_rm_tpu_torch.controlplane.api import gpu as gpu_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    annotations_of,
    deep_get,
    name_of,
    namespace_of,
)
from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer

#: namespace the synthetic harvest-gang charges live under in the
#: scheduler cache — never a real apiserver namespace, so no controller
#: or relist can ever collide with a lease key
HARVEST_NAMESPACE = "serving-harvest"

#: suspend reason stamped on donors the controller parks itself
HARVEST_REASON = "harvest"

#: the r15 failover SLO budget (seconds): a warm-standby promotion —
#: detection to fully-ready — must land inside this envelope
#: (``notebook_failover_seconds`` bucket bound; measured p50 sits ~3
#: orders of magnitude under it). A harvest reclaim rides the SAME
#: demand-resume path, so its p95 must fit the same budget — the
#: conformance storm and test suite assert against this constant.
FAILOVER_SLO_S = 2.5


@dataclass
class HarvestLease:
    """One serving replica running on one donor notebook's chips."""
    replica: str                      # fleet replica name
    donor: tuple[str, str]            # (namespace, name) of the notebook
    keys: tuple[tuple[str, str], ...]  # scheduler charge keys
    nodes: tuple[str, ...]            # nodes the gang landed on
    chips: float                      # total chips held
    granted_at: float                 # time.monotonic() at grant

    def spec(self) -> dict:
        return {"replica": self.replica,
                "donor": "/".join(self.donor),
                "nodes": list(self.nodes),
                "chips": self.chips}


class ChipHarvestController:
    """Tick-driven: measure pressure, grant leases, reclaim on demand.

    Drive :meth:`tick` from a harness loop (the conformance storms) or
    a background thread; :meth:`reclaim` is also invoked synchronously
    by the scheduler (via ``sched.harvest_reclaimer``) when a notebook
    gang fails to bind — that path is what bounds resume latency by
    the failover SLO instead of a tick period.

    ``gateway_factory(name) -> ServingGateway`` supplies the replica
    the controller binds onto freed chips; the harness builds it
    against the shared model params. ``observer`` (anything with
    ``engine.state_of(slo)``, JAX's ``obs.Observer`` shape) is optional —
    without it, pressure falls back to decode queue depth alone.
    """

    def __init__(self, api: APIServer, fleet, *, gateway_factory,
                 observer=None, sched=None,
                 idle_minutes: float = 15.0,
                 pressure_depth: float = 4.0,
                 burn_slos: tuple = ("serving-victim-p95",),
                 sustain: int = 2,
                 give_back_after: int = 4,
                 max_leases: int = 4,
                 reclaim_grace_s: float = 0.05,
                 store=None):
        self.api = api
        self.fleet = fleet
        self.gateway_factory = gateway_factory
        self.observer = observer
        self.sched = (sched if sched is not None
                      else scheduler.cache_for(api))
        self.idle_minutes = float(idle_minutes)
        self.pressure_depth = float(pressure_depth)
        self.burn_slos = tuple(burn_slos)
        self.sustain = int(sustain)
        self.give_back_after = int(give_back_after)
        self.max_leases = int(max_leases)
        self.reclaim_grace_s = float(reclaim_grace_s)
        self.store = store
        # ordering: harvest -> fleet(435)/scheduler is the only
        # direction — nothing under those locks calls back into us
        self._lock = make_lock("harvest.controller")
        self._leases: dict[str, HarvestLease] = {}
        #: donors we suspended ourselves, awaiting SUSPEND_DRAINED
        self._pending: dict[tuple[str, str], float] = {}
        self._seq = 0
        self._hot = 0
        self._calm = 0
        # the reclaim hook is how "notebook outranks serving" reaches
        # the bind path without the scheduler importing this module
        self.sched.harvest_reclaimer = self.reclaim

    # ---- introspection ---------------------------------------------------

    def leases(self) -> list[dict]:
        with self._lock:
            return [ls.spec() for ls in self._leases.values()]

    def lease_count(self) -> int:
        with self._lock:
            return len(self._leases)

    # ---- the tick --------------------------------------------------------

    def tick(self) -> str:
        """One pass: reclaim resumed donors, finish pending grants,
        then act on the pressure signal. Returns the decision taken
        ("reclaim" | "grant" | "suspend" | "give_back" | "hold")."""
        if self._reclaim_resumed_donors():
            return "reclaim"
        acted = self._complete_pending()
        hot = self._pressure()
        if hot:
            self._hot += 1
            self._calm = 0
        else:
            self._calm += 1
            self._hot = 0
        if acted:
            return "grant"
        if hot and self._hot >= self.sustain:
            with self._lock:
                outstanding = len(self._leases) + len(self._pending)
            if outstanding < self.max_leases:
                return self._start_harvest()
            return "hold"
        if (not hot and self._calm >= self.give_back_after
                and self.lease_count() > 0):
            self._give_back_oldest()
            return "give_back"
        return "hold"

    # ---- pressure signal -------------------------------------------------

    def _pressure(self) -> bool:
        """Serving wants more chips: any watched SLO burning past ok,
        or the mean ready-replica decode queue deeper than the
        threshold."""
        if self.observer is not None:
            for slo in self.burn_slos:
                try:
                    if self.observer.engine.state_of(slo) != "ok":
                        return True
                except KeyError:
                    pass
        snap = self.fleet.snapshot()
        depths = [r["queue_depth"] for r in snap["replicas"].values()
                  if r["state"] == "ready"
                  and (r["role"] in (None, "decode"))]
        if not depths:
            return False
        return sum(depths) / len(depths) >= self.pressure_depth

    # ---- donor selection -------------------------------------------------

    def _harvestable(self) -> list[dict]:
        """Donor candidates, best first: already-drained Suspended
        notebooks (free chips, nobody to suspend), then running
        notebooks idle past the threshold. Pinned, culling-excluded,
        CPU-only, and mid-lifecycle notebooks are never donors."""
        drained, idle = [], []
        now = self.api.clock()
        with self._lock:
            pending = set(self._pending)
            donors = {ls.donor for ls in self._leases.values()}
        for nb in self.api.list(nb_api.KIND):
            key = (namespace_of(nb), name_of(nb))
            if key in pending or key in donors:
                continue
            if nb_api.tpu_spec(nb) is None:
                continue
            ann = annotations_of(nb)
            if (nb_api.is_pinned(nb)
                    or ann.get(nb_api.CULLING_EXCLUDE_ANNOTATION)
                    == "true"):
                continue
            if nb_api.RESUME_REQUESTED_ANNOTATION in ann:
                continue  # being resumed: the worst possible donor
            if nb_api.SUSPEND_ANNOTATION in ann:
                if nb_api.SUSPEND_DRAINED_ANNOTATION in ann:
                    drained.append(nb)
                continue  # suspending but not drained yet: wait
            last = suspend._parse_ts(
                ann.get(nb_api.LAST_ACTIVITY_ANNOTATION))
            if last is None:
                last = suspend._parse_ts(
                    nb["metadata"].get("creationTimestamp"))
            if last is None:
                continue
            if (now - last).total_seconds() >= self.idle_minutes * 60.0:
                idle.append(nb)
        # smallest slice first: harvest the cheapest donor that
        # satisfies pressure, keep big slices for their owners
        drained.sort(key=nb_api.total_hosts)
        idle.sort(key=nb_api.total_hosts)
        return drained + idle

    def _start_harvest(self) -> str:
        for nb in self._harvestable():
            ann = annotations_of(nb)
            if nb_api.SUSPEND_DRAINED_ANNOTATION in ann:
                if self._bind_lease(nb) is not None:
                    return "grant"
                continue  # freed slice got taken; try the next donor
            # running but idle: park it through the normal lifecycle,
            # bind once the SuspendController stamps the drain
            live = suspend.initiate_suspend(
                self.api, nb, reason=HARVEST_REASON, store=self.store)
            if (nb_api.SUSPEND_REASON_ANNOTATION in annotations_of(live)
                    and annotations_of(live).get(
                        nb_api.SUSPEND_REASON_ANNOTATION)
                    == HARVEST_REASON):
                with self._lock:
                    self._pending[(namespace_of(live), name_of(live))] \
                        = time.monotonic()
                return "suspend"
        return "hold"

    def _complete_pending(self) -> bool:
        """Bind leases for donors we parked once their drain lands."""
        with self._lock:
            pending = list(self._pending)
        acted = False
        for key in pending:
            ns, name = key
            nb = self.api.try_get(nb_api.KIND, name, ns)
            if nb is None:
                with self._lock:
                    self._pending.pop(key, None)
                continue
            ann = annotations_of(nb)
            if nb_api.SUSPEND_ANNOTATION not in ann:
                # resumed before we ever bound: lease never existed
                with self._lock:
                    self._pending.pop(key, None)
                continue
            if nb_api.SUSPEND_DRAINED_ANNOTATION not in ann:
                continue  # still draining
            with self._lock:
                self._pending.pop(key, None)
            if self._bind_lease(nb) is not None:
                acted = True
        return acted

    # ---- grant -----------------------------------------------------------

    def _gang_pods(self, replica: str, topo, hosts: int) -> list[dict]:
        """Synthetic pods shaped like the donor's: same per-host chip
        request, same accelerator selector — the gang lands only on
        nodes the donor could have."""
        selector = {gpu_api.NODE_LABEL_ACCELERATOR: topo.gke_accelerator}
        if topo.multihost:
            selector[gpu_api.NODE_LABEL_TOPOLOGY] = topo.topology
        return [{
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"{replica}-{i}",
                         "namespace": HARVEST_NAMESPACE},
            "spec": {
                "nodeSelector": dict(selector),
                "containers": [{
                    "name": "serve",
                    "resources": {"limits": {
                        gpu_api.NVIDIA_GPU_RESOURCE:
                            str(topo.cards_per_host)}},
                }],
            },
        } for i in range(hosts)]

    def _bind_lease(self, notebook: dict):
        """Charge a harvest gang for the donor's slice shape, spin the
        replica, register it. Returns the lease or None (didn't fit —
        the freed chips were taken by real notebook demand, which is
        the priority order working as intended)."""
        topo = nb_api.tpu_spec(notebook)
        if topo is None:
            return None
        hosts = nb_api.total_hosts(notebook)
        with self._lock:
            self._seq += 1
            replica = f"harvest-{self._seq}"
        pods = self._gang_pods(replica, topo, hosts)
        plan = self.sched.gang_bind(pods, allow_virtual=False,
                                    prefer_whole_nodes=True)
        if plan is None:
            return None
        # leases stay ASSUMED on purpose: no apiserver pod will ever
        # confirm them, and rebuild() preserves assumed entries
        for key in plan:
            self.sched.mark_harvested(key)
        try:
            gw = self.gateway_factory(replica)
            role = "decode" if self.fleet.roles is not None else None
            self.fleet.add_replica(replica, gw, role)
        except Exception:
            for key in plan:
                self.sched.release_harvested(key)
            metrics.swallowed("harvest", "replica spin-up")
            return None
        lease = HarvestLease(
            replica=replica,
            donor=(namespace_of(notebook), name_of(notebook)),
            keys=tuple(sorted(plan)),
            nodes=tuple(sorted(set(plan.values()))),
            chips=float(hosts * topo.cards_per_host),
            granted_at=time.monotonic())
        with self._lock:
            self._leases[replica] = lease
        metrics.HARVEST_GRANTS_TOTAL.inc()
        self.api.record_event(
            notebook, "Normal", "Harvested",
            f"serving replica {replica} borrowing the idle slice "
            f"({lease.chips:.0f} chip(s) on {list(lease.nodes)}); "
            "returns instantly on any resume")
        return lease

    # ---- reclaim ---------------------------------------------------------

    def _reclaim_resumed_donors(self) -> bool:
        """A donor with a resume in flight (or already running, or
        deleted) gets its chips back NOW — this is the tick-side
        mirror of the synchronous ``try_preempt`` path, covering
        resumes whose re-bind succeeded elsewhere or whose notebook
        vanished entirely."""
        with self._lock:
            leases = list(self._leases.values())
        reclaimed = False
        for ls in leases:
            ns, name = ls.donor
            nb = self.api.try_get(nb_api.KIND, name, ns)
            if nb is not None:
                ann = annotations_of(nb)
                if (nb_api.SUSPEND_ANNOTATION in ann
                        and nb_api.RESUME_REQUESTED_ANNOTATION
                        not in ann):
                    continue  # still parked: lease stands
            self._release_lease(ls, trigger="resume")
            reclaimed = True
        if reclaimed:
            # freed chips emit no event any controller watches;
            # requeue waiting gangs exactly like a drain does
            suspend.kick_pending_pods(
                self.api, now=self.api.clock().isoformat())
        return reclaimed

    def reclaim(self, nodes=None, trigger: str = "preempt") -> float:
        """The ``sched.harvest_reclaimer`` hook: give back every lease
        touching ``nodes`` (all leases when None) and return the chips
        freed. Called with no scheduler locks held."""
        with self._lock:
            leases = [ls for ls in self._leases.values()
                      if nodes is None or set(ls.nodes) & set(nodes)]
        freed = 0.0
        for ls in leases:
            freed += self._release_lease(ls, trigger=trigger)
        return freed

    def _release_lease(self, lease: HarvestLease, *,
                       trigger: str) -> float:
        with self._lock:
            if self._leases.pop(lease.replica, None) is None:
                return 0.0  # raced another reclaimer; already gone
        t0 = time.perf_counter()
        try:
            # drain-first: queued + mid-decode requests migrate to the
            # rest of the fleet (store-held prefixes keep them exact)
            self.fleet.remove_replica(lease.replica,
                                      grace_s=self.reclaim_grace_s)
        except ValueError:
            # last (or last-decode) replica: the fleet would rather
            # die than the notebook wait — kill keeps the chips' side
            # of the contract even when serving loses its quorum
            self.fleet.kill(lease.replica)
        except KeyError:
            pass  # replica already gone (chaos killed it): chips still ours to free
        for key in lease.keys:
            self.sched.release_harvested(key)
        dt = time.perf_counter() - t0
        metrics.HARVEST_RECLAIMS_TOTAL.labels(trigger=trigger).inc()
        metrics.HARVEST_RECLAIM_SECONDS.observe(dt)
        nb = self.api.try_get(nb_api.KIND, lease.donor[1],
                              lease.donor[0])
        if nb is not None:
            self.api.record_event(
                nb, "Normal", "HarvestReturned",
                f"serving replica {lease.replica} drained off the "
                f"borrowed slice in {dt * 1e3:.1f}ms ({trigger}); "
                f"{lease.chips:.0f} chip(s) back in the pool")
        return lease.chips

    def _give_back_oldest(self) -> None:
        with self._lock:
            if not self._leases:
                return
            oldest = min(self._leases.values(),
                         key=lambda ls: ls.granted_at)
        self._release_lease(oldest, trigger="idle_giveback")

    # ---- teardown --------------------------------------------------------

    def close(self) -> None:
        """Return every lease (shutdown path) and detach the hook."""
        self.reclaim(trigger="idle_giveback")
        if self.sched.harvest_reclaimer is self.reclaim:
            self.sched.harvest_reclaimer = None
