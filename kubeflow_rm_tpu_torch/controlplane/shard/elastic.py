"""Elastic shard layer: live split/merge with WAL-replay handoff,
plus the SLO/queue-depth-driven shard autoscaler (the port's copy of
``kubeflow_rm_tpu/controlplane/shard/elastic.py``).

Without it the ring is fixed at boot; this module makes it elastic.
A handoff moves a key-range between shard processes using the SAME
machinery crash recovery already trusts — snapshot + WAL
tail-replay — instead of inventing a second replication protocol:

    IDLE ──► SNAPSHOT   donor forces a compacting snapshot
                        (bounds the tail the copy must chase)
         ──► COPY       bulk-apply the moving range to the recipient
                        (read-only ``read_state`` on the donor's WAL
                        dir; the donor keeps serving)
         ──► TAIL       replay donor WAL records past the horizon,
                        pass by pass, until lag < threshold
         ──► FENCE      router holds writes whose key changes owner
                        (predicate fence: even namespaces CREATED now)
         ──► DRAIN      final tail passes until two consecutive reads
                        find nothing new (donor acks are WAL-durable
                        before the client sees them, so "nothing new
                        on disk" == "nothing in flight")
         ──► FLIP       ``router.set_topology`` swaps ring + clients +
                        watch loops in one assignment each; unfence —
                        every held write re-resolves to the NEW owner
         ──► CLEANUP    donor's stale copies deleted best-effort
                        (the router's ownership filter makes them
                        inert either way)

A **split** admits a fresh empty shard (every existing member donates
the slice of its range the new vnodes claim). A **merge** retires one
member (it donates everything it owns to the survivors) and then stops
it through the runner's intentional-shutdown handshake — deliberate
scale-down is not a death. A **pinned migration** moves one namespace
to a chosen shard (``HashRing`` pins), which is how a notebook's
live-migration crosses shard boundaries.

Zero-loss argument: a client write is acked only after the donor's WAL
fsyncs it. Writes acked before the fence are on disk and carried by
TAIL/DRAIN; writes issued during the fence block client-side and land
on the recipient after FLIP; the donor cannot ack a fenced-range write
between DRAIN and FLIP because fenced clients never send one. The
``shard_split`` chaos arm SIGKILLs the donor between COPY and TAIL —
recovery is the watchdog's respawn plus more tail passes against the
same WAL, which is exactly the property crash recovery rests on.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock
from kubeflow_rm_tpu_torch.controlplane import chaos, metrics
from kubeflow_rm_tpu_torch.controlplane.apiserver import (
    CLUSTER_SCOPED_KINDS,
    AlreadyExists,
    APIError,
    Conflict,
    NotFound,
)
from kubeflow_rm_tpu_torch.controlplane.deploy.kubeclient import (
    BROADCAST_KINDS,
    KubeAPIServer,
    _is_transient,
)
from kubeflow_rm_tpu_torch.controlplane.persistence import (
    read_state,
    tail_records,
)
from kubeflow_rm_tpu_torch.controlplane.persistence.snapshot import (
    load_latest_snapshot,
)
from kubeflow_rm_tpu_torch.controlplane.shard.ring import HashRing

log = logging.getLogger("kubeflow_rm_tpu_torch.shard.elastic")

#: kinds that never ride a handoff: per-process liveness state (each
#: worker's LeaderElector lease lives in its OWN store and dies with
#: the process) — moving one would hand a zombie lease to the recipient
LOCAL_KINDS = frozenset({"Lease"})

#: apply order for a bulk copy: containers before their contents, the
#: audit trail last (anything unlisted lands in the middle)
_KIND_ORDER = {"Namespace": 0, "Profile": 1, "ServiceAccount": 2,
               "RoleBinding": 3, "PodDefault": 4, "Notebook": 5,
               "TPUJob": 5, "Deployment": 6, "StatefulSet": 6,
               "Pod": 8, "Event": 9}


def partition_key(kind: str, name: str | None,
                  namespace: str | None) -> str:
    """The ring key of one object — mirrors the router's rule."""
    if kind in CLUSTER_SCOPED_KINDS:
        return name or ""
    return namespace or ""


class ElasticShardManager:
    """The split/merge/migrate coordinator. Runs in the harness (or
    deployment-controller) process next to the router; talks to donors
    via their WAL directories (read-only) and to recipients via
    per-shard kube clients. One handoff at a time."""

    def __init__(self, runner, router, *, observer=None,
                 lag_threshold: int = 4, max_tail_passes: int = 200,
                 drain_settle_s: float = 0.15,
                 identity: str = "elastic"):
        self.runner = runner
        self.router = router
        self.observer = observer
        self.lag_threshold = int(lag_threshold)
        self.max_tail_passes = int(max_tail_passes)
        self.drain_settle_s = float(drain_settle_s)
        self.identity = identity
        self._lock = make_lock("shard.elastic")
        self._clients: dict[str, KubeAPIServer] = {}
        #: timeline of completed operations (the conformance artifact's
        #: ``scale_events`` section)
        self.events: list[dict] = []
        self._t0 = time.monotonic()

    # ---- plumbing ----------------------------------------------------
    def _client(self, name: str) -> KubeAPIServer:
        cli = self._clients.get(name)
        if cli is None:
            cli = KubeAPIServer(self.runner.urls[name],
                                identity=self.identity,
                                cache_reads=False)
            self._clients[name] = cli
        return cli

    def _post(self, name: str, path: str, body: dict | None = None,
              timeout: float = 15.0) -> dict:
        def go():
            req = urllib.request.Request(
                self.runner.urls[name] + path,
                data=json.dumps(body or {}).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return json.loads(r.read() or b"{}")
        return self._ride_out(go)

    def _ride_out(self, fn, window_s: float = 20.0):
        """Run ``fn`` retrying transient TRANSPORT failures for up to
        ``window_s``. A handoff peer may be mid-respawn after a chaos
        kill — connection-refused while it replays its WAL is part of
        the recovery story, not an error. API-level errors (conflict,
        not-found, validation) pass straight through untouched."""
        deadline = time.monotonic() + window_s
        while True:
            try:
                return fn()
            except APIError:
                raise
            except Exception as e:
                if isinstance(e, urllib.error.HTTPError) \
                        or not _is_transient(e) \
                        or time.monotonic() >= deadline:
                    raise  # server answered (or window exhausted)
                time.sleep(0.1)

    def _event(self, op: str, **detail) -> None:
        self.events.append({
            "t": round(time.monotonic() - self._t0, 3), "op": op,
            "members": list(self.router.ring.members), **detail})

    # ---- public verbs ------------------------------------------------
    def split(self, name: str | None = None, *,
              weight: int | None = None,
              dedicate: str | None = None) -> str:
        """Admit one new shard: spawn it empty, hand it the range the
        new ring assigns it, flip. Returns the new shard's name.

        ``weight`` caps the newcomer's vnode count (``with_weight``);
        ``dedicate`` pins one partition key to it (``with_pin``).
        Together they make a **carve-off**: weight=1 means the new
        shard claims almost none of the hash range, so the pinned
        namespace is effectively all it serves — a dedicated shard for
        a hot tenant instead of an even rebalance. One ring
        derivation, one handoff, one flip."""
        with self._lock:
            t0 = time.monotonic()
            new_name = self.runner.add_shard(name)
            new_ring = self.router.ring.with_member(new_name)
            if weight is not None:
                new_ring = new_ring.with_weight(new_name, weight)
            if dedicate is not None:
                new_ring = new_ring.with_pin(dedicate, new_name)
            stats = self._handoff(new_ring, op="split",
                                  fresh=new_name)
            metrics.SHARD_SPLITS_TOTAL.inc()
            metrics.SHARD_HANDOFF_SECONDS.labels(kind="split").observe(
                time.monotonic() - t0)
            if self.observer is not None:
                self.observer.tsdb.add_scrape(
                    new_name, self.runner.urls[new_name])
            if dedicate is not None:
                stats = dict(stats, dedicate=dedicate)
            self._event("split", shard=new_name, **stats)
            log.info("split: admitted %s (%s)", new_name, stats)
            return new_name

    def merge(self, victim: str | None = None) -> str:
        """Retire one shard: hand its whole range to the survivors,
        flip, then stop it via the intentional-shutdown handshake.
        Returns the retired shard's name."""
        with self._lock:
            members = self.router.ring.members
            if len(members) < 2:
                raise ValueError("cannot merge below one shard")
            if victim is None:
                victim = self._default_victim(members)
            t0 = time.monotonic()
            new_ring = self.router.ring.without_member(victim)
            stats = self._handoff(new_ring, op="merge",
                                  retiring=victim)
            # stop AFTER the flip: routing already ignores the victim,
            # and the handshake keeps the watchdog + shard-deaths SLO
            # quiet about this deliberate exit
            self.runner.remove_shard(victim)
            self._clients.pop(victim, None)
            if self.observer is not None:
                self.observer.tsdb.remove_scrape(victim)
            metrics.SHARD_MERGES_TOTAL.inc()
            metrics.SHARD_HANDOFF_SECONDS.labels(kind="merge").observe(
                time.monotonic() - t0)
            self._event("merge", shard=victim, **stats)
            log.info("merge: retired %s (%s)", victim, stats)
            return victim

    def migrate_namespace(self, key: str, target: str) -> bool:
        """Pin one partition key (a namespace, or a cluster-scoped
        name) to ``target`` and hand its objects over. Returns False
        when the key already lives there."""
        with self._lock:
            ring = self.router.ring
            if target not in ring.members:
                raise ValueError(f"{target!r} not a ring member")
            if ring.shard_for(key) == target:
                return False
            t0 = time.monotonic()
            if ring.hash_owner(key) == target:
                new_ring = ring.without_pin(key)  # hash already agrees
            else:
                new_ring = ring.with_pin(key, target)
            stats = self._handoff(new_ring, op="migrate")
            metrics.SHARD_HANDOFF_SECONDS.labels(
                kind="migrate").observe(time.monotonic() - t0)
            self._event("migrate", key=key, target=target, **stats)
            return True

    def migrate_notebook(self, namespace: str, name: str,
                         target: str) -> bool:
        """Cross-shard notebook live-migration, riding the handoff
        path: move the notebook's whole namespace (CR, StatefulSet,
        pods, checkpoint annotations) to ``target`` with a pinned
        handoff, then drive ``suspend.initiate_migration`` THROUGH the
        router — which now routes the namespace to the target shard,
        whose suspend controller drains the stale placement (the old
        shard's node names mean nothing there) and re-gangs the slice
        on its own node pool with state restored."""
        moved = self.migrate_namespace(namespace, target)
        from kubeflow_rm_tpu_torch.controlplane import suspend
        nb = self.router.try_get("Notebook", name, namespace)
        if nb is None:
            raise NotFound(f"Notebook {namespace}/{name} not found "
                           "after handoff")
        suspend.initiate_migration(self.router, nb,
                                   trigger="cross-shard")
        return moved

    # ---- the handoff core --------------------------------------------
    def _default_victim(self, members: list[str]) -> str:
        """Retire the youngest member (highest index): splits append
        shard-N, so scale-down unwinds scale-up."""
        def idx(m: str) -> tuple:
            tail = m.rsplit("-", 1)[-1]
            return (int(tail), m) if tail.isdigit() else (-1, m)
        return max(members, key=idx)

    def _handoff(self, new_ring: HashRing, *, op: str,
                 fresh: str | None = None,
                 retiring: str | None = None) -> dict:
        """Copy + tail-replay every key whose owner changes between the
        router's current ring and ``new_ring``, then fence-drain-flip.
        Returns counters for the operation timeline."""
        router = self.router
        old_ring = router.ring
        for m in old_ring.members:
            if self.runner.wal_dir(m) is None:
                raise RuntimeError(
                    "elastic handoff requires WAL-backed shards")

        def moves(pkey: str) -> bool:
            return old_ring.shard_for(pkey) != new_ring.shard_for(pkey)

        # per-donor session: replay horizon + the moved objects we
        # believe live (for deletion diffing across snapshot races)
        sessions: dict[str, dict] = {}
        bulk = tail = 0
        for donor in old_ring.members:
            if donor == fresh:
                continue
            try:
                self._post(donor, "/debug/snapshot")
            except Exception:  # noqa: BLE001 - donor may be respawning
                metrics.swallowed("shard.elastic", "donor snapshot")
            st = read_state(self.runner.wal_dir(donor),
                            CLUSTER_SCOPED_KINDS)
            moving: dict[tuple, dict] = {}
            for key, obj in st.objects.items():
                kind, ns, nm = key
                if kind in BROADCAST_KINDS or kind in LOCAL_KINDS:
                    continue
                pk = partition_key(kind, nm, ns)
                if old_ring.shard_for(pk) == donor and moves(pk):
                    moving[key] = obj
            if not moving and fresh is None:
                continue
            # recipients adopt the donor's rv horizon BEFORE any copy
            recipients = {new_ring.shard_for(
                partition_key(k[0], k[2], k[1])) for k in moving}
            if fresh is not None:
                recipients.add(fresh)
            for r in recipients:
                try:
                    self._post(r, "/debug/rv_floor", {"rv": st.rv})
                except Exception:  # noqa: BLE001
                    metrics.swallowed("shard.elastic", "rv floor")
            # a recipient may hold a stale range tombstone for a key
            # that left it in an EARLIER handoff and is now coming
            # back; lift it before adopting, or the recipient's next
            # respawn would purge the live range it just received
            incoming: dict[str, set] = {}
            for k in moving:
                pk = partition_key(k[0], k[2], k[1])
                incoming.setdefault(new_ring.shard_for(pk),
                                    set()).add(pk)
            for r, pks in incoming.items():
                try:
                    self._post(r, "/debug/tombstone",
                               {"clear": sorted(pks)})
                except Exception:  # noqa: BLE001
                    metrics.swallowed("shard.elastic",
                                      "recipient stone lift")
            # donor uid -> recipient uid: recipients mint fresh uids on
            # create, so every copied ownerReference must be remapped
            # or the recipient's controllers disown the copied children
            # (and duplicate them forever). Kind order applies owners
            # before their dependents, so the map is always warm.
            uids: dict[str, str] = {}
            if fresh is not None and not sessions:
                # first donor also seeds the fresh shard's replicated
                # broadcast kinds (ClusterRoles, CRDs, ...)
                for key, obj in st.objects.items():
                    if key[0] in BROADCAST_KINDS:
                        self._apply(fresh, obj, uids)
                        bulk += 1
            live: dict[tuple, str] = {}
            for key, obj in sorted(
                    moving.items(),
                    key=lambda kv: (_KIND_ORDER.get(kv[0][0], 5),
                                    kv[0])):
                recipient = new_ring.shard_for(
                    partition_key(key[0], key[2], key[1]))
                self._apply(recipient, obj, uids)
                live[key] = recipient
                bulk += 1
            sessions[donor] = {"horizon": st.seq,
                               "snap": st.snapshot_seq, "live": live,
                               "uids": uids}
        metrics.SHARD_HANDOFF_OBJECTS.labels(phase="bulk").inc(bulk)

        # seeded chaos: SIGKILL the busiest donor between COPY and
        # TAIL — the watchdog respawns it from this very WAL and the
        # tail passes below chase the recovered log
        if op == "split" and sessions:
            busiest = max(sessions, key=lambda d: len(
                sessions[d]["live"]))
            if chaos.split_kill_fault(f"split:{busiest}"):
                log.warning("chaos: SIGKILLing donor %s mid-split",
                            busiest)
                try:
                    self.runner.kill(busiest)
                except (OSError, KeyError):
                    metrics.swallowed("shard.elastic", "chaos kill")

        # TAIL: chase each donor's WAL until the whole pass is quiet
        passes = 0
        while passes < self.max_tail_passes:
            lag = 0
            for donor, sess in sessions.items():
                lag += self._tail_pass(donor, sess, new_ring, moves)
            tail += lag
            metrics.SHARD_HANDOFF_REPLAY_LAG.set(lag)
            if lag <= self.lag_threshold:
                break
            passes += 1
            time.sleep(0.02)

        # FENCE + DRAIN: hold moving-range writes, then read until two
        # consecutive passes find nothing — acks are WAL-durable
        # before clients see them, so quiet disk == quiet range
        router.fence(moves)
        try:
            quiet = 0
            deadline = time.monotonic() + 10.0
            while quiet < 2 and time.monotonic() < deadline:
                time.sleep(self.drain_settle_s)
                lag = 0
                for donor, sess in sessions.items():
                    lag += self._tail_pass(donor, sess, new_ring,
                                           moves)
                tail += lag
                quiet = quiet + 1 if lag == 0 else 0
            # FLIP: one topology swap; held writes re-resolve to the
            # new owners the moment the fence lifts
            urls = {m: self.runner.urls[m] for m in new_ring.members}
            router.set_topology(urls, pins=new_ring.pins)
            # TOMBSTONE: ownership has transferred but the donor's WAL
            # still holds the moved range. Stone it NOW — a donor that
            # crashes before CLEANUP below would otherwise respawn
            # with the moved objects live again (two owners, and the
            # donor's controllers reconciling ghosts). Not earlier: a
            # handoff that aborts pre-FLIP must leave the donor able
            # to recover its own (still-owned) range.
            for donor, sess in sessions.items():
                if donor == retiring or not sess["live"]:
                    continue
                pks = sorted({partition_key(k[0], k[2], k[1])
                              for k in sess["live"]})
                try:
                    self._post(donor, "/debug/tombstone", {"set": pks})
                except Exception:  # noqa: BLE001
                    metrics.swallowed("shard.elastic", "donor stone")
        finally:
            router.unfence()
        metrics.SHARD_HANDOFF_OBJECTS.labels(phase="tail").inc(tail)
        metrics.SHARD_HANDOFF_REPLAY_LAG.set(0)

        # CLEANUP: the donor's copies of moved objects are now inert
        # (ownership-filtered at the router); delete them best-effort
        # so the donor's controllers stop reconciling ghosts. A
        # retiring donor skips this — the whole process goes away.
        removed = 0
        for donor, sess in sessions.items():
            if donor == retiring:
                continue
            removed += self._cleanup_donor(donor, sess["live"])
            # the moved objects are deleted from the donor's WAL, so
            # its stones have done their job; lift them to keep the
            # stone set from accreting across many rebalances
            if sess["live"]:
                pks = sorted({partition_key(k[0], k[2], k[1])
                              for k in sess["live"]})
                try:
                    self._post(donor, "/debug/tombstone",
                               {"clear": pks})
                except Exception:  # noqa: BLE001
                    metrics.swallowed("shard.elastic",
                                      "donor stone lift")
        return {"objects_bulk": bulk, "objects_tail": tail,
                "tail_passes": passes, "cleaned": removed}

    def _tail_pass(self, donor: str, sess: dict, new_ring: HashRing,
                   moves) -> int:
        """One replay pass over ``donor``'s WAL past the session
        horizon; applies moving-range records to their recipients.
        Returns the number applied. Falls back to a full state re-read
        + diff when the donor compacted past our horizon (its
        background snapshot unlinked segments we had not read)."""
        wal = self.runner.wal_dir(donor)
        applied = 0
        doc = load_latest_snapshot(wal)
        disk_snap = int(doc["seq"]) if doc else 0
        if disk_snap > max(sess["horizon"], sess["snap"]):
            st = read_state(wal, CLUSTER_SCOPED_KINDS)
            fresh_live: dict[tuple, str] = {}
            for key, obj in st.objects.items():
                kind, ns, nm = key
                if kind in BROADCAST_KINDS or kind in LOCAL_KINDS:
                    continue
                pk = partition_key(kind, nm, ns)
                if not moves(pk):
                    continue
                recipient = new_ring.shard_for(pk)
                self._apply(recipient, obj, sess["uids"])
                fresh_live[key] = recipient
                applied += 1
            for key, recipient in sess["live"].items():
                if key not in fresh_live:
                    self._delete(recipient, key)
                    applied += 1
            sess["live"] = fresh_live
            sess["horizon"] = st.seq
            sess["snap"] = st.snapshot_seq
            return applied
        for rec in tail_records(wal, sess["horizon"]):
            sess["horizon"] = max(sess["horizon"],
                                  int(rec.get("seq", 0)))
            obj = rec.get("obj")
            if obj is None:
                continue
            kind = obj.get("kind")
            meta = obj.get("metadata") or {}
            if kind in BROADCAST_KINDS or kind in LOCAL_KINDS:
                continue
            ns = None if kind in CLUSTER_SCOPED_KINDS \
                else meta.get("namespace")
            nm = meta.get("name")
            pk = partition_key(kind, nm, ns)
            if not moves(pk):
                continue
            recipient = new_ring.shard_for(pk)
            key = (kind, ns, nm)
            if rec.get("verb") == "DELETE":
                self._delete(recipient, key)
                sess["live"].pop(key, None)
            else:
                self._apply(recipient, obj, sess["uids"])
                sess["live"][key] = recipient
            applied += 1
        return applied

    def _apply(self, shard: str, obj: dict,
               uid_map: dict | None = None) -> None:
        """Upsert one object through the recipient's normal API (its
        admission chain re-runs — idempotent for everything this
        platform writes). rv/uid are the DONOR's; strip them so the
        recipient issues fresh ones above its adopted rv floor, and
        record donor-uid -> recipient-uid in ``uid_map`` so copied
        children's ownerReferences re-attach to their copied owners
        (controllers match dependents strictly by owner uid)."""
        cli = self._client(shard)
        o = json.loads(json.dumps(obj))  # records are shared; never
        md = o.setdefault("metadata", {})  # mutate the caller's copy
        md.pop("resourceVersion", None)
        old_uid = md.pop("uid", None)
        if uid_map is not None:
            for ref in md.get("ownerReferences") or []:
                if ref.get("uid") in uid_map:
                    ref["uid"] = uid_map[ref["uid"]]

        def note(applied: dict) -> None:
            if uid_map is not None and old_uid:
                new_uid = (applied.get("metadata") or {}).get("uid")
                if new_uid:
                    uid_map[old_uid] = new_uid

        kind, nm = o.get("kind"), md.get("name")
        ns = md.get("namespace")
        for _attempt in range(4):
            try:
                note(self._ride_out(lambda: cli.create(o)))
                return
            except AlreadyExists:
                try:
                    cur = self._ride_out(lambda: cli.get(kind, nm, ns))
                except NotFound:
                    continue  # deleted underneath; retry the create
                md["resourceVersion"] = (cur.get("metadata") or {}).get(
                    "resourceVersion")
                try:
                    note(self._ride_out(lambda: cli.update(o)))
                    return
                except (Conflict, NotFound):
                    continue
            except APIError:
                # validation/admission refused the copy (e.g. a kind
                # with server-owned lifecycle): count it, move on —
                # the tail pass will retry if it changes again
                metrics.swallowed("shard.elastic", "apply refused")
                return
        metrics.swallowed("shard.elastic", "apply contention")

    def _delete(self, shard: str, key: tuple) -> None:
        kind, ns, nm = key
        try:
            self._ride_out(
                lambda: self._client(shard).delete(kind, nm, ns))
        except NotFound:
            pass
        except APIError:
            metrics.swallowed("shard.elastic", "handoff delete")

    def _cleanup_donor(self, donor: str, live: dict) -> int:
        """Best-effort removal of moved objects from a surviving
        donor, parents first so its controllers cascade instead of
        resurrect. Never touches the shard-local control plumbing."""
        cli = self._client(donor)
        removed = 0
        for key in sorted(live, key=lambda k: (_KIND_ORDER.get(
                k[0], 5), k)):
            kind, ns, nm = key
            if kind in LOCAL_KINDS or (kind, nm) == ("Namespace",
                                                     "kubeflow"):
                continue
            try:
                cli.delete(kind, nm, ns)
                removed += 1
            except NotFound:
                removed += 1
            except (APIError, OSError):
                metrics.swallowed("shard.elastic", "donor cleanup")
        return removed


class ShardAutoscaler:
    """Queue-depth + SLO-burn-driven elasticity: split on sustained
    pressure, merge back on sustained idle. Deterministic — the
    harness drives ``tick()``; nothing here owns a thread.

    Signals, per tick:
    - mean per-shard ``workqueue_depth`` from the federated TSDB
      (``instance=<shard>`` series the Observer scrapes), and
    - the SLO burn-rate engine: any watched SLO sitting in
      ``critical`` counts as pressure — but only while there is work
      queued. A critical *latency* SLO over an empty fleet means the
      burn windows still hold samples from traffic that already
      drained; capacity cannot fix a window, so it must not pin the
      fleet wide overnight.

    ``sustain`` consecutive pressure ticks split (up to ``max_shards``,
    the 2→6 of the diurnal story); ``sustain`` idle ticks merge (down
    to ``min_shards``). ``cooldown_s`` after every action stops
    thrash while the fleet re-settles.

    **Hot-namespace carve-off**: when ONE namespace accounts for at
    least ``carve_fraction`` of a deep shard's queue (the per-namespace
    ``workqueue_namespace_depth`` series the workqueues export), an
    even split would move random ranges while the hot tenant keeps
    drowning whichever shard the hash gives it. Instead the autoscaler
    carves: ``split(weight=carve_weight, dedicate=ns)`` admits a
    near-weightless shard (vnodes=1 claims ~no hash range) and pins
    the hot namespace to it — a dedicated shard for the noisy tenant,
    everyone else's routing untouched. A namespace that is already
    pinned is never re-carved; when it cools, the ordinary merge path
    retires its shard and ``without_member`` drops the pin."""

    def __init__(self, elastic: ElasticShardManager, observer, *,
                 min_shards: int = 2, max_shards: int = 6,
                 split_depth: float = 8.0, merge_depth: float = 1.0,
                 sustain: int = 3, cooldown_s: float = 5.0,
                 carve_fraction: float = 0.6, carve_weight: int = 1,
                 burn_slos: tuple = ("provision-p50", "wal-fsync",
                                     "scheduler-latency")):
        self.elastic = elastic
        self.observer = observer
        self.min_shards = int(min_shards)
        self.max_shards = int(max_shards)
        self.split_depth = float(split_depth)
        self.merge_depth = float(merge_depth)
        self.sustain = int(sustain)
        self.cooldown_s = float(cooldown_s)
        self.carve_fraction = float(carve_fraction)
        self.carve_weight = int(carve_weight)
        self.burn_slos = tuple(burn_slos)
        self._high = 0
        self._idle = 0
        self._hot_ns: str | None = None
        self._hot = 0
        self._last_action = 0.0
        #: decision log for the conformance artifact
        self.decisions: list[dict] = []

    def _burning(self) -> bool:
        eng = self.observer.engine
        for name in self.burn_slos:
            try:
                if eng.state_of(name) == "critical":
                    return True
            except KeyError:
                continue
        return False

    def _mean_depth(self) -> float:
        members = self.elastic.router.ring.members
        total = 0.0
        for shard in members:
            v = self.observer.tsdb.latest("workqueue_depth",
                                          {"instance": shard})
            total += v or 0.0
        return total / max(len(members), 1)

    def _hot_namespace(self) -> str | None:
        """The namespace dominating one deep shard's queue, or None.
        A namespace already pinned (previously carved, or a notebook
        live-migration pin) is never a candidate — its shard IS its
        dedicated shard; re-carving would thrash."""
        tsdb = self.observer.tsdb
        ring = self.elastic.router.ring
        try:
            spaces = tsdb.label_values("workqueue_namespace_depth",
                                       "namespace")
        except AttributeError:
            return None  # reduced fakes without the breakdown
        for shard in ring.members:
            total = tsdb.latest("workqueue_depth",
                                {"instance": shard}) or 0.0
            if total < self.split_depth:
                continue
            for ns in spaces:
                if ring.pins.get(ns) is not None \
                        or ring.shard_for(ns) != shard:
                    continue
                v = tsdb.latest("workqueue_namespace_depth",
                                {"instance": shard,
                                 "namespace": ns}) or 0.0
                if v / total >= self.carve_fraction:
                    return ns
        return None

    def tick(self, now: float | None = None) -> str:
        """One evaluation; returns the decision taken
        (``split`` | ``carve`` | ``merge`` | ``hold`` |
        ``cooldown``)."""
        now = time.monotonic() if now is None else now
        n = len(self.elastic.router.ring)
        depth = self._mean_depth()
        burning = self._burning()
        if depth >= self.split_depth or \
                (burning and depth > self.merge_depth):
            self._high += 1
            self._idle = 0
        elif depth <= self.merge_depth:
            self._idle += 1
            self._high = 0
        else:
            self._high = self._idle = 0
        hot = self._hot_namespace()
        if hot is not None and hot == self._hot_ns:
            self._hot += 1
        else:
            self._hot_ns = hot
            self._hot = 1 if hot is not None else 0
        decision = "hold"
        if self._last_action and \
                now - self._last_action < self.cooldown_s:
            decision = "cooldown"
        elif hot is not None and self._hot >= self.sustain \
                and n < self.max_shards:
            # carve beats even split: the pressure is one tenant, so
            # give THAT tenant a dedicated (near-weightless) shard
            self.elastic.split(weight=self.carve_weight, dedicate=hot)
            self._hot_ns, self._hot = None, 0
            self._high = 0
            self._last_action = time.monotonic()
            decision = "carve"
        elif self._high >= self.sustain and n < self.max_shards:
            self.elastic.split()
            self._high = 0
            self._last_action = time.monotonic()
            decision = "split"
        elif self._idle >= self.sustain and n > self.min_shards:
            self.elastic.merge()
            self._idle = 0
            self._last_action = time.monotonic()
            decision = "merge"
        metrics.SHARD_AUTOSCALE_DECISIONS_TOTAL.labels(
            decision=decision).inc()
        self.decisions.append({
            "t": round(now, 3), "decision": decision, "shards": n,
            "mean_depth": round(depth, 2), "burning": burning,
            "high": self._high, "idle": self._idle, "hot": hot})
        return decision
