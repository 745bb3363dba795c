"""Consistent-hash ring partitioning the control plane by namespace.

Deterministic across processes (md5, no seed): the router in the
client, every shard worker, and the conformance harness all compute
the same ``shard_for(namespace)`` with no coordination. Virtual nodes
smooth the partition (#vnodes ≫ #shards keeps the largest shard within
a few percent of fair share); a restarted shard rejoins under the same
name at the same position, so "retry-with-remap" on the client
resolves to the same shard once it is back.

Elastic membership (split/merge): ``with_member`` / ``without_member``
derive the NEXT ring from this one without mutating it — the handoff
coordinator computes the moved key-set against both rings, copies
state, and only then flips the router to the new ring, so routing is
never observed mid-rebuild. ``moved_keys`` is the range-ownership
delta that drives a handoff; consistent hashing bounds it to roughly
1/N of the keyspace per membership change.

Pins: an explicit ``key -> member`` override consulted before the
hash. Cross-shard notebook migration moves ONE namespace to a chosen
target (not where the hash puts it); the pin makes that routing
deterministic for every client that shares the pin map.

Weights: heterogeneous members carry per-member vnode counts
(``weights``, defaulting to ``vnodes``). A member with 2x the vnodes
owns ~2x the keyspace — how a big shard box takes a proportionally
bigger share. ``with_weight`` derives the re-weighted ring; because
every member's points are independent (``hash(f"{m}#{v}")``), raising
one member's weight only ADDS that member's points, so every moved
key moves TO it — and lowering it only moves keys FROM it. The
movement is minimal in the same sense as membership changes.

Partition key: a namespaced object's namespace; a cluster-scoped
object's NAME (Profile "alice" and Namespace "alice" hash identically,
keeping a profile, its namespace, and everything inside on one shard).

(The port's copy of ``kubeflow_rm_tpu/controlplane/shard/ring.py``,
verbatim: a point is the first 8 bytes of the md5 of
``"<member>#<vnode>"``, big-endian, so both packages put the same key
on the same member name. The serving fleet and the control plane's
router, :class:`..deploy.kubeclient.ShardedKubeAPIServer`, use it.)
"""

from __future__ import annotations

import bisect
import hashlib

DEFAULT_VNODES = 64


def _hash(key: str) -> int:
    return int.from_bytes(
        hashlib.md5(key.encode()).digest()[:8], "big")


class HashRing:
    def __init__(self, members: list[str], *,
                 vnodes: int = DEFAULT_VNODES,
                 pins: dict[str, str] | None = None,
                 weights: dict[str, int] | None = None):
        if not members:
            raise ValueError("HashRing needs at least one member")
        self.members = sorted(members)
        self.vnodes = vnodes
        self.pins = dict(pins or {})
        # per-member vnode override; members absent here get `vnodes`
        self.weights = {m: int(n) for m, n in (weights or {}).items()
                        if m in self.members}
        for m, n in self.weights.items():
            if n < 1:
                raise ValueError(
                    f"weight for {m!r} must be >= 1, got {n}")
        for key, owner in self.pins.items():
            if owner not in self.members:
                raise ValueError(
                    f"pin {key!r} -> {owner!r}: not a ring member")
        self._points: list[int] = []
        self._owners: list[str] = []
        pairs = sorted(
            (_hash(f"{m}#{v}"), m)
            for m in self.members
            for v in range(self.weights.get(m, vnodes)))
        for point, owner in pairs:
            self._points.append(point)
            self._owners.append(owner)

    def shard_for(self, key: str | None) -> str:
        """The member owning ``key`` (a namespace, or a cluster-scoped
        object's name). ``None`` — e.g. a cluster-wide list — is the
        caller's cue to fan out, but routes deterministically here."""
        pinned = self.pins.get(key or "")
        if pinned is not None:
            return pinned
        i = bisect.bisect_right(self._points, _hash(key or "")) \
            % len(self._points)
        return self._owners[i]

    def hash_owner(self, key: str | None) -> str:
        """Where the hash alone puts ``key``, ignoring pins — a pin
        whose target matches this is redundant and can be dropped."""
        i = bisect.bisect_right(self._points, _hash(key or "")) \
            % len(self._points)
        return self._owners[i]

    def spread(self, keys) -> dict[str, list[str]]:
        """Group ``keys`` by owning member (routing bulk writes)."""
        out: dict[str, list[str]] = {m: [] for m in self.members}
        for k in keys:
            out[self.shard_for(k)].append(k)
        return out

    # ---- elastic membership ------------------------------------------
    def with_member(self, name: str) -> "HashRing":
        """The ring after a split admits ``name``. Pins survive (their
        targets are all still members)."""
        if name in self.members:
            raise ValueError(f"{name!r} already a ring member")
        return HashRing(self.members + [name], vnodes=self.vnodes,
                        pins=self.pins, weights=self.weights)

    def without_member(self, name: str,
                       drop_pins: bool = True) -> "HashRing":
        """The ring after a merge retires ``name``. Pins targeting the
        leaving member are dropped (their keys fall back to the hash
        and ride the merge handoff like any other key)."""
        if name not in self.members:
            raise ValueError(f"{name!r} not a ring member")
        rest = [m for m in self.members if m != name]
        if not rest:
            raise ValueError("cannot remove the last ring member")
        pins = {k: o for k, o in self.pins.items() if o != name}
        if not drop_pins and len(pins) != len(self.pins):
            raise ValueError(f"pins still target {name!r}")
        weights = {m: n for m, n in self.weights.items() if m != name}
        return HashRing(rest, vnodes=self.vnodes, pins=pins,
                        weights=weights)

    def with_weight(self, member: str, n_vnodes: int) -> "HashRing":
        """The ring with ``member`` carrying ``n_vnodes`` virtual
        nodes. Ownership shifts proportionally, and every moved key
        involves ``member`` (gains on raise, losses on lower) — other
        members never exchange keys with each other."""
        if member not in self.members:
            raise ValueError(f"{member!r} not a ring member")
        if n_vnodes < 1:
            raise ValueError(
                f"weight for {member!r} must be >= 1, got {n_vnodes}")
        weights = dict(self.weights)
        weights[member] = int(n_vnodes)
        return HashRing(self.members, vnodes=self.vnodes,
                        pins=self.pins, weights=weights)

    def weight_of(self, member: str) -> int:
        return self.weights.get(member, self.vnodes)

    def with_pin(self, key: str, member: str) -> "HashRing":
        """The ring with ``key`` explicitly owned by ``member``. A pin
        matching the hash owner is stored anyway — callers may drop it
        later via ``with_pin``'s inverse (``without_pin``)."""
        if member not in self.members:
            raise ValueError(f"{member!r} not a ring member")
        pins = dict(self.pins)
        pins[key] = member
        return HashRing(self.members, vnodes=self.vnodes, pins=pins,
                        weights=self.weights)

    def without_pin(self, key: str) -> "HashRing":
        pins = dict(self.pins)
        pins.pop(key, None)
        return HashRing(self.members, vnodes=self.vnodes, pins=pins,
                        weights=self.weights)

    def moved_keys(self, new: "HashRing", keys) -> dict[str, tuple]:
        """The ownership delta driving a handoff: key ->
        (old_owner, new_owner) for every key whose owner changes
        between ``self`` and ``new``."""
        out: dict[str, tuple] = {}
        for k in keys:
            a, b = self.shard_for(k), new.shard_for(k)
            if a != b:
                out[k] = (a, b)
        return out

    def __len__(self) -> int:
        return len(self.members)
