"""Consistent-hash ring (counterpart of
``kubeflow_rm_tpu/controlplane/shard/ring.py``), with only what the
serving fleet calls: the ring over its members with ``vnodes`` virtual
nodes each, ``shard_for``/``hash_owner``, and ``with_member``/
``without_member``, which derive the next ring without mutating this
one.

Deterministic across processes and packages: a point is the first 8
bytes of the md5 of ``"<member>#<vnode>"``, big-endian, as in JAX's ring
(``ring.py:46-49``), so the same key goes to the same member name in
both. Membership changes move only the keys that must move.
"""

from __future__ import annotations

import bisect
import hashlib

DEFAULT_VNODES = 64


def _hash(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class HashRing:
    def __init__(self, members: list[str], *, vnodes: int = DEFAULT_VNODES):
        if not members:
            raise ValueError("HashRing needs at least one member")
        self.members = sorted(members)
        self.vnodes = vnodes
        pairs = sorted((_hash(f"{m}#{v}"), m)
                       for m in self.members for v in range(vnodes))
        self._points = [p for p, _ in pairs]
        self._owners = [m for _, m in pairs]

    def shard_for(self, key: str | None) -> str:
        """The member owning ``key`` (``None`` routes as ``""``)."""
        i = bisect.bisect_right(self._points, _hash(key or "")) \
            % len(self._points)
        return self._owners[i]

    #: where the hash puts ``key``: this copy keeps no pins, so it is
    #: ``shard_for``
    hash_owner = shard_for

    def with_member(self, name: str) -> "HashRing":
        """The ring after ``name`` joins."""
        if name in self.members:
            raise ValueError(f"{name!r} already a ring member")
        return HashRing(self.members + [name], vnodes=self.vnodes)

    def without_member(self, name: str) -> "HashRing":
        """The ring after ``name`` leaves."""
        if name not in self.members:
            raise ValueError(f"{name!r} not a ring member")
        rest = [m for m in self.members if m != name]
        if not rest:
            raise ValueError("cannot remove the last ring member")
        return HashRing(rest, vnodes=self.vnodes)

    def __len__(self) -> int:
        return len(self.members)
