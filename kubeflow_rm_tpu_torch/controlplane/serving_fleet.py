"""Multi-replica serving fleet: cache-affinity routing and migration
(counterpart of ``kubeflow_rm_tpu/controlplane/serving_fleet.py``).

N ``ServingGateway``-wrapped engines behind one front door. Three
routing rules, in order:

1. **Cache affinity.** The routing key is the hash of the prompt's first
   ``prefix_tokens`` token ids (one KV block, the granularity at which
   ``models.paging`` names blocks), so requests that share a system
   prompt land on the replica that already holds its blocks. The key
   rides a consistent-hash ring (``shard/ring.py``): a membership change
   moves only the keys that must move.
2. **Session stickiness.** A request with a ``session`` routes by
   ``s:<session>``: every turn returns to the replica holding the
   conversation's blocks.
3. **Load spill.** If the owner's queue is ``spill_depth`` deep and a
   strictly shallower ready replica exists, the request spills there.

The ring holds READY replicas only and is rebuilt when one drains or
dies. In-flight requests on a drained or killed replica are not failed:
their ``wait`` raises ``ReplicaUnavailable`` with the tokens produced so
far, and ``submit_and_wait`` resubmits ``prompt + tokens_so_far`` with
the rest of the budget elsewhere; greedy decode continues exactly.

**Disaggregated mode** (``roles=...``): a prefill tier runs
``prefill_chain`` and exports the finished chain into the fleet-wide
:class:`GlobalBlockStore`, named by the chained ``prefix_keys`` hashes
the pools use, so ANY decode replica can adopt it by hash; decode
replicas are chosen by queue depth. A chain a decode pool evicts at ref
0 is *promoted* into the store on the way out (``BlockPool.on_evict``),
so a prefix outlives the replica that computed it.

A chain crosses the wire as :func:`chain_to_bytes` frames, byte for byte
the JAX package's: a bf16 cache's K/V are named ``bfloat16`` there, and
the port, which holds them as their ``uint16`` bits (``paging.to_host``),
writes the same bytes under that name and reads them back as bits.

Locking: ``serving.fleet`` (level 435) guards only the state map and the
cached ring; every blocking call (submit, wait, drain, close) happens
outside it. The store's ``serving.store`` (445) sits above the gateway's
lock (440), because promote-on-evict fires inside an engine step, under
the owning gateway's lock, where it copies a block from the card to the
host.
"""

from __future__ import annotations

import hashlib
import json
import time
from collections import OrderedDict

import numpy as np

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock
from kubeflow_rm_tpu_torch.controlplane import metrics as cp_metrics
from kubeflow_rm_tpu_torch.controlplane.shard.ring import HashRing
from kubeflow_rm_tpu_torch.controlplane.webapps.serving import (
    HTTPError, ReplicaUnavailable, ServingGateway, parse_generate,
    read_json, require_method, respond, shed_response, tenant_of,
)
from kubeflow_rm_tpu_torch.models import paging

READY, DRAINING, DEAD = "ready", "draining", "dead"

ROLES = ("prefill", "decode")

#: the K/V arrays whose ``uint16`` dtype means bf16 bits
_BF16_ARRAYS = ("chunks_k", "chunks_v")


def _wire_dtype(name: str, a: np.ndarray) -> str:
    """The dtype name a frame gives array ``name``: the JAX package's
    ``bfloat16`` for the port's bf16 bits."""
    if name in _BF16_ARRAYS and a.dtype == np.uint16:
        return "bfloat16"
    return a.dtype.name


def _np_dtype(name: str) -> np.dtype:
    """A frame's dtype by name; ``bfloat16`` (which numpy does not
    register) is read as its ``uint16`` bits."""
    return np.dtype(np.uint16 if name == "bfloat16" else name)


def chain_to_bytes(chain: dict) -> bytes:
    """Wire format of a prefix chain: a 4-byte big-endian header length,
    the JSON header (keys and sums in hex, shapes, dtype names), then the
    raw array buffers. Checksums ride in the header, so a decode replica
    verifies before seating anything."""
    arrays = [("chunks_k", chain["chunks_k"]),
              ("chunks_v", chain["chunks_v"]),
              ("chunks_pos", chain["chunks_pos"])]
    if chain.get("last_logits") is not None:
        arrays.append(("last_logits", chain["last_logits"]))
    header = {
        "version": 1,
        "block_size": int(chain["block_size"]),
        "covered": int(chain["covered"]),
        "keys": [k.hex() for k in chain["keys"]],
        "covers": [int(c) for c in chain["covers"]],
        "sums": [s.hex() for s in chain["sums"]],
        "nbytes": int(chain["nbytes"]),
        "arrays": [{"name": n, "shape": list(a.shape),
                    "dtype": _wire_dtype(n, a)} for n, a in arrays],
    }
    if chain.get("tokens") is not None:
        header["tokens"] = [int(t) for t in chain["tokens"]]
    hj = json.dumps(header).encode()
    payload = b"".join(np.ascontiguousarray(a).tobytes() for _n, a in arrays)
    return len(hj).to_bytes(4, "big") + hj + payload


def chain_from_bytes(buf: bytes) -> dict:
    """Inverse of :func:`chain_to_bytes`. Raises ``ValueError`` on a
    malformed frame; the chunks' integrity is checked again by
    ``paging.verify_chain`` when the chain is imported."""
    if len(buf) < 4:
        raise ValueError("chain frame too short")
    hlen = int.from_bytes(buf[:4], "big")
    try:
        header = json.loads(buf[4:4 + hlen])
    except ValueError as e:
        raise ValueError(f"chain header is not JSON: {e}") from e
    chain = {
        "version": int(header["version"]),
        "block_size": int(header["block_size"]),
        "covered": int(header["covered"]),
        "keys": [bytes.fromhex(k) for k in header["keys"]],
        "covers": [int(c) for c in header["covers"]],
        "sums": [bytes.fromhex(s) for s in header["sums"]],
        "nbytes": int(header["nbytes"]),
    }
    if "tokens" in header:
        chain["tokens"] = [int(t) for t in header["tokens"]]
    off = 4 + hlen
    for spec in header["arrays"]:
        dt = _np_dtype(spec["dtype"])
        shape = tuple(spec["shape"])
        n = dt.itemsize * int(np.prod(shape))
        raw = buf[off:off + n]
        if len(raw) != n:
            raise ValueError("chain frame truncated")
        chain[spec["name"]] = np.frombuffer(raw, dtype=dt).reshape(
            shape).copy()
        off += n
    return chain


class GlobalBlockStore:
    """Fleet-wide content-addressed prefix-chain store.

    Entries are whole chains keyed by their LAST prefix key (a chained
    hash, which commits to every token before it); every interior key is
    indexed too, so a prompt that shares only the first blocks of a
    stored chain still finds the longest usable truncation. Publishing a
    chain supersedes stored chains that are strict prefixes of it.
    Eviction is LRU under a byte budget; a just-published chain is never
    evicted by its own publish.

    Two producers: prefill replicas ``publish`` whole chains (with their
    tokens and final logits, so a decode replica skips prefill), and
    decode pools ``extend`` it a chunk at a time as they evict a ref-0
    block (promotion: no tokens, no logits, adoptable prefix bytes that
    survive the replica).

    Lock level 445 (``serving.store``), above the gateway's.
    """

    def __init__(self, *, max_bytes: int = 64 << 20):
        self._lock = make_lock("serving.store")
        self.max_bytes = int(max_bytes)
        self._entries: OrderedDict[bytes, dict] = OrderedDict()
        # every prefix key -> (owning chain id, chunks up to that key)
        self._by_key: dict[bytes, tuple[bytes, int]] = {}
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.published = 0
        self.promoted = 0
        self.superseded = 0
        self.evicted = 0
        self.skipped_extends = 0

    # -- internals (lock held) -----------------------------------------

    def _drop_locked(self, chain_id: bytes) -> None:
        entry = self._entries.pop(chain_id)
        self.bytes -= entry["nbytes"]
        for k in entry["keys"]:
            if self._by_key.get(k, (None, 0))[0] == chain_id:
                del self._by_key[k]

    def _gauges_locked(self) -> None:
        total = self.hits + self.misses
        if total:
            cp_metrics.SERVING_STORE_HIT_RATIO.set(self.hits / total)
            cp_metrics.SERVING_STORE_MISS_RATIO.set(self.misses / total)
        cp_metrics.SERVING_STORE_CHAINS.set(len(self._entries))
        cp_metrics.SERVING_STORE_BYTES.set(self.bytes)

    def _hit_locked(self, chain_id: bytes, nch: int) -> dict:
        entry = self._entries[chain_id]
        self._entries.move_to_end(chain_id)
        self.hits += 1
        self._gauges_locked()
        return self._slice_locked(entry, nch)

    def _miss_locked(self) -> None:
        self.misses += 1
        self._gauges_locked()

    @staticmethod
    def _slice_locked(entry: dict, nch: int) -> dict:
        """A chain truncated to ``nch`` chunks. ``tokens`` and
        ``last_logits`` survive only a FULL match: a truncated chain is
        adoptable prefix bytes, not a prefill's replacement."""
        full = nch == len(entry["keys"])
        covered = int(entry["covers"][nch - 1])
        ck = entry["chunks_k"][:, :nch]
        cv = entry["chunks_v"][:, :nch]
        cp = entry["chunks_pos"][:nch]
        out = {
            "version": 1,
            "block_size": entry["block_size"],
            "covered": covered,
            "keys": list(entry["keys"][:nch]),
            "covers": list(entry["covers"][:nch]),
            "chunks_k": ck,
            "chunks_v": cv,
            "chunks_pos": cp,
            "sums": list(entry["sums"][:nch]),
            "nbytes": int(ck.nbytes + cv.nbytes + cp.nbytes),
        }
        if "tokens" in entry:
            out["tokens"] = (list(entry["tokens"]) if full
                             else list(entry["tokens"][:covered]))
        if full and "last_logits" in entry:
            out["last_logits"] = entry["last_logits"]
        return out

    # -- producer side -------------------------------------------------

    def publish(self, chain: dict, *, promoted: bool = False) -> bool:
        """Insert a verified chain; False if the exact chain (the same
        final key) is already stored (it is freshened in the LRU)."""
        paging.verify_chain(chain)
        keys = list(chain["keys"])
        chain_id = keys[-1]
        entry = {
            "keys": keys,
            "covers": [int(c) for c in chain["covers"]],
            "chunks_k": np.asarray(chain["chunks_k"]),
            "chunks_v": np.asarray(chain["chunks_v"]),
            "chunks_pos": np.asarray(chain["chunks_pos"]),
            "sums": list(chain["sums"]),
            "block_size": int(chain["block_size"]),
            "covered": int(chain["covered"]),
            "nbytes": int(chain["nbytes"]),
        }
        if chain.get("tokens") is not None:
            entry["tokens"] = [int(t) for t in chain["tokens"]]
        if chain.get("last_logits") is not None:
            entry["last_logits"] = np.asarray(chain["last_logits"])
        with self._lock:
            if chain_id in self._entries:
                self._entries.move_to_end(chain_id)
                self._gauges_locked()
                return False
            for k in keys[:-1]:
                if k in self._entries:   # a strict prefix of the newcomer
                    self._drop_locked(k)
                    self.superseded += 1
            self._entries[chain_id] = entry
            self.bytes += entry["nbytes"]
            for i, k in enumerate(keys):
                self._by_key[k] = (chain_id, i + 1)
            self.published += 1
            if promoted:
                self.promoted += 1
                cp_metrics.SERVING_STORE_PROMOTED_TOTAL.inc()
            while self.bytes > self.max_bytes and len(self._entries) > 1:
                oldest = next(iter(self._entries))
                if oldest == chain_id:
                    break
                self._drop_locked(oldest)
                self.evicted += 1
            self._gauges_locked()
        return True

    def extend(self, parent_key: bytes | None, key: bytes,
               chunk: dict, covered: int) -> bool:
        """Promotion: one sanitised block chunk
        (``paging.export_block_chunk``) grows a stored chain by one
        block. ``parent_key is None`` starts a one-chunk chain; an
        unknown parent is skipped (the store holds only chains it can
        verify end to end)."""
        with self._lock:
            if parent_key is None:
                base_k = chunk["k"][:, None]
                base_v = chunk["v"][:, None]
                base_p = chunk["pos"][None]
                keys, covers, sums = [key], [int(covered)], [chunk["sum"]]
                block_size = int(chunk["pos"].shape[0])
            else:
                got = self._by_key.get(parent_key)
                if got is None:
                    self.skipped_extends += 1
                    return False
                chain_id, nch = got
                entry = self._entries[chain_id]
                block_size = int(entry["block_size"])
                pcov = int(entry["covers"][nch - 1])
                # the parent must end exactly at this chunk's block
                # boundary, on a full block: the hashes vouch for
                # nothing else
                if (pcov % block_size
                        or pcov != ((int(covered) - 1)
                                    // block_size) * block_size):
                    self.skipped_extends += 1
                    return False
                base_k = np.concatenate(
                    [entry["chunks_k"][:, :nch], chunk["k"][:, None]], axis=1)
                base_v = np.concatenate(
                    [entry["chunks_v"][:, :nch], chunk["v"][:, None]], axis=1)
                base_p = np.concatenate(
                    [entry["chunks_pos"][:nch], chunk["pos"][None]], axis=0)
                keys = list(entry["keys"][:nch]) + [key]
                covers = list(entry["covers"][:nch]) + [int(covered)]
                sums = list(entry["sums"][:nch]) + [chunk["sum"]]
        chain = {
            "version": 1,
            "block_size": block_size,
            "covered": covers[-1],
            "keys": keys,
            "covers": covers,
            "chunks_k": base_k,
            "chunks_v": base_v,
            "chunks_pos": base_p,
            "sums": sums,
            "nbytes": int(base_k.nbytes + base_v.nbytes + base_p.nbytes),
        }
        return self.publish(chain, promoted=True)

    # -- consumer side -------------------------------------------------

    def lookup(self, keys) -> dict | None:
        """Longest-prefix match of a prompt's ``prefix_keys`` pairs
        against the stored chains: a (possibly truncated) chain, or
        None. Counts toward the hit and miss gauges."""
        pairs = list(keys)
        with self._lock:
            for _covered, key in reversed(pairs):
                got = self._by_key.get(key)
                if got is not None:
                    return self._hit_locked(*got)
            self._miss_locked()
            return None

    def get_chain(self, key: bytes) -> dict | None:
        """The chain of one prefix key, truncated to that key's depth
        (the ``/api/store/chain/<hex>`` fetch)."""
        with self._lock:
            got = self._by_key.get(key)
            if got is None:
                self._miss_locked()
                return None
            return self._hit_locked(*got)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "chains": len(self._entries),
                "bytes": self.bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "hit_ratio": (self.hits / total) if total else None,
                "published": self.published,
                "promoted": self.promoted,
                "superseded": self.superseded,
                "evicted": self.evicted,
                "skipped_extends": self.skipped_extends,
            }


class NoReadyReplica(Exception):
    """Every replica is draining or dead: the fleet cannot admit."""


class ServingFleet:
    """Affinity router and migration loop over named gateways."""

    def __init__(self, gateways: dict[str, ServingGateway], *,
                 prefix_tokens: int | None = None, spill_depth: int = 8,
                 vnodes: int = 16,
                 roles: dict[str, str] | None = None,
                 store: GlobalBlockStore | None = None,
                 store_bytes: int = 64 << 20):
        if not gateways:
            raise ValueError("fleet needs at least one replica")
        self.gateways = dict(gateways)
        if prefix_tokens is None:
            eng = next(iter(self.gateways.values())).engine
            prefix_tokens = getattr(eng, "block_size", None) or 16
        self.prefix_tokens = int(prefix_tokens)
        self.spill_depth = spill_depth
        self._vnodes = vnodes
        self._lock = make_lock("serving.fleet")
        self._state = {name: READY for name in self.gateways}
        self._ring = HashRing(sorted(self.gateways), vnodes=vnodes)
        self.migrations = 0
        self.spills = 0
        self.handoffs = 0
        if roles is not None:
            roles = dict(roles)
            if set(roles) != set(self.gateways):
                raise ValueError("roles must name every replica, exactly")
            bad = sorted(set(roles.values()) - set(ROLES))
            if bad:
                raise ValueError(f"unknown roles {bad}; expected "
                                 f"{'|'.join(ROLES)}")
            if "decode" not in roles.values():
                raise ValueError(
                    "disaggregated fleet needs >= 1 decode replica")
            if store is None:
                store = GlobalBlockStore(max_bytes=store_bytes)
        self.roles = roles
        self.store = store
        for gw in self.gateways.values():
            self._hook_promotion(gw)
        self._publish_states()
        self._publish_tiers()

    # -- membership / state ------------------------------------------------

    def _hook_promotion(self, gw: ServingGateway) -> None:
        """Promote-on-evict: a paged pool dropping a ref-0 block hands its
        bytes to the store on the way out."""
        if self.store is not None and gw.engine.paged:
            gw.engine.pool.on_evict = self._promote_hook(gw.engine)

    def _publish_states(self) -> None:
        counts = {READY: 0, DRAINING: 0, DEAD: 0}
        for s in self._state.values():
            counts[s] += 1
        for s, n in counts.items():
            cp_metrics.SERVING_FLEET_REPLICAS.labels(s).set(n)

    def _rebuild_ring_locked(self) -> None:
        ready = [m for m in self.gateways if self._state[m] == READY]
        self._ring = (HashRing(ready, vnodes=self._vnodes)
                      if ready else None)
        self._publish_states()

    def _set_state(self, name: str, state: str) -> None:
        with self._lock:
            self._state[name] = state
            self._rebuild_ring_locked()

    def add_replica(self, name: str, gateway: ServingGateway,
                    role: str | None = None) -> None:
        """Grow the fleet live: ``name`` joins the ring READY. On a
        disaggregated fleet ``role`` is required; the store makes every
        published prefix adoptable by the newcomer at once."""
        with self._lock:
            if name in self.gateways:
                raise ValueError(f"replica {name!r} already in fleet")
            if self.roles is not None:
                if role not in ROLES:
                    raise ValueError(
                        f"disaggregated fleet: role must be one of "
                        f"{'|'.join(ROLES)}, got {role!r}")
                self.roles[name] = role
            elif role is not None:
                raise ValueError("role given but fleet is not "
                                 "disaggregated (no roles=...)")
            self.gateways[name] = gateway
            self._state[name] = READY
            self._rebuild_ring_locked()
        self._hook_promotion(gateway)
        self._publish_tiers()

    def remove_replica(self, name: str,
                       *, grace_s: float = 0.0) -> ServingGateway:
        """Shrink the fleet live: drain ``name`` (out of the ring, its
        queued work migrates), let active slots finish for up to
        ``grace_s``, then close it: the requests still in flight take
        the kill-migration path and complete exactly elsewhere. Returns
        the detached gateway."""
        with self._lock:
            if name not in self.gateways:
                raise KeyError(f"no replica {name!r}")
            if len(self.gateways) == 1:
                raise ValueError("cannot remove the last replica")
            if (self.roles is not None
                    and self.roles.get(name) == "decode"
                    and sum(1 for m, r in self.roles.items()
                            if r == "decode" and m != name) == 0):
                raise ValueError("cannot remove the last decode replica")
        self.drain(name)
        gw = self.gateways[name]
        if grace_s > 0:
            deadline = time.monotonic() + grace_s
            while gw.engine.active_slots and time.monotonic() < deadline:
                time.sleep(0.005)
        gw.close()
        with self._lock:
            self.gateways.pop(name, None)
            self._state.pop(name, None)
            if self.roles is not None:
                self.roles.pop(name, None)
            self._rebuild_ring_locked()
        self._publish_tiers()
        return gw

    def drain(self, name: str) -> None:
        """Pull ``name`` out of rotation: the ring drops it, its healthz
        flips 503, its queued requests migrate, its active slots
        finish."""
        self._set_state(name, DRAINING)
        self.gateways[name].start_drain()

    def kill(self, name: str) -> None:
        """Hard-kill ``name``: every in-flight request, queued AND
        mid-decode, migrates to another replica."""
        self._set_state(name, DEAD)
        self.gateways[name].close()

    def states(self) -> dict[str, str]:
        with self._lock:
            return dict(self._state)

    def _publish_tiers(self) -> None:
        if self.roles is None:
            return
        for tier in ROLES:
            names = [m for m, r in self.roles.items() if r == tier]
            slots = sum(self.gateways[m].engine.slots for m in names)
            active = sum(self.gateways[m].engine.active_slots
                         for m in names)
            cp_metrics.SERVING_TIER_OCCUPANCY.labels(tier).set(
                active / max(1, slots))

    def _promote_hook(self, eng):
        """Called by ``BlockPool._evict_one`` with the dying block still
        resident, inside an engine step under the owning gateway's lock
        (gateway 440 → store 445: uphill). LRU evicts oldest first, so a
        chain's head chunk promotes before its successors."""
        def hook(key: bytes, block: int) -> None:
            pool = eng.pool
            covered = pool.covered_of(key)
            if covered is None:
                return      # registered before chains; nothing to vouch
            BS = pool.block_size
            valid = covered - ((covered - 1) // BS) * BS
            chunk = paging.export_block_chunk(eng.cache, block, valid)
            self.store.extend(pool.parent_of(key), key, chunk, covered)
        return hook

    # -- routing -----------------------------------------------------------

    def affinity_key(self, prompt: list[int],
                     session: str | None = None) -> str:
        if session:
            return f"s:{session}"
        head = prompt[: self.prefix_tokens]
        return "p:" + hashlib.md5(
            b",".join(str(t).encode() for t in head)).hexdigest()

    def route(self, prompt: list[int], session: str | None = None,
              *, exclude: set[str] | None = None) -> str:
        """The replica for this request; ``NoReadyReplica`` when nothing
        can take it."""
        key = self.affinity_key(prompt, session)
        with self._lock:
            ready = [m for m in sorted(self.gateways)
                     if self._state[m] == READY
                     and m not in (exclude or ())]
            if not ready:
                raise NoReadyReplica("no ready serving replica")
            ring = (self._ring if not exclude and self._ring is not None
                    else HashRing(ready, vnodes=self._vnodes))
            owner = ring.shard_for(key)
            # the gateway objects, taken under the lock: a concurrent
            # remove_replica may pop names the moment it is released
            gws = {m: self.gateways[m] for m in ready}
        depth = gws[owner].engine.queue_depth
        if depth >= self.spill_depth and len(ready) > 1:
            shallowest = min(ready, key=lambda m: gws[m].engine.queue_depth)
            if (gws[shallowest].engine.queue_depth < depth
                    and shallowest != owner):
                self.spills += 1
                return shallowest
        return owner

    def _shallowest(self, role: str, exclude=None) -> str | None:
        """The READY replica of ``role`` with the shortest queue."""
        with self._lock:
            ready = [m for m in sorted(self.gateways)
                     if self._state[m] == READY and self.roles[m] == role
                     and m not in (exclude or ())]
            gws = {m: self.gateways[m] for m in ready}
        if not ready:
            return None
        return min(ready, key=lambda m: gws[m].engine.queue_depth)

    def _route_decode(self, *, exclude: set[str] | None = None) -> str:
        """Disaggregated decode routing: the store makes the prefix
        portable, so queue depth is the only signal."""
        name = self._shallowest("decode", exclude)
        if name is None:
            raise NoReadyReplica("no ready decode replica")
        return name

    def _stage_prefix(self, gw: ServingGateway,
                      prompt: list[int]) -> dict | None:
        """Decode-side prefix staging for one disaggregated request.

        Returns a FULL chain to install (the decode replica skips
        prefill), or None after the best thing available: nothing (the
        prompt is already local), adopting a partial store hit (the
        local prefix cache then absorbs the covered head), or, on a
        store miss, running the prompt through the prefill tier and
        publishing the result, so the NEXT request for this prefix hits
        the store."""
        eng = gw.engine
        if gw.chain_coverage(prompt) >= len(prompt) - 1:
            return None     # local blocks already cover the prompt
        keys = paging.prefix_keys(prompt, eng.block_size)
        entry = self.store.lookup(keys)
        if entry is not None:
            if (entry.get("tokens") == prompt
                    and entry.get("last_logits") is not None):
                return entry    # exact hit: install, skip prefill
            gw.adopt_chain(entry)   # partial: seat the covered head
            return None
        pf = self._shallowest("prefill")
        pf_gw = self.gateways.get(pf) if pf is not None else None
        if pf_gw is None:
            return None     # prefill tier down: decode-local prefill
        t0 = time.monotonic()
        try:
            chain = pf_gw.prefill_chain(prompt)
        except ValueError:
            return None     # prompt outside the prefill slot shape
        if chain is None:
            return None     # draining, or the pool too full to hold it
        self.store.publish(chain)
        self.handoffs += 1
        cp_metrics.SERVING_CHAIN_HANDOFF_SECONDS.observe(
            time.monotonic() - t0)
        return chain

    # -- request lifecycle -------------------------------------------------

    def submit_and_wait(self, tenant: str, prompt: list[int], *,
                        max_new_tokens: int, eos_id: int | None = None,
                        slo_class: str | None = None,
                        session: str | None = None,
                        speculative: bool = False,
                        timeout_s: float = 300.0):
        """Route, decode and, if the replica goes away mid-flight,
        migrate and resume. Returns ``(tokens, info)``, or ``(None,
        info)`` on a shed; ``info`` has the replica path and the shed
        reason. A migrated request resumes from the tokens it produced
        (greedy continuation equals an uninterrupted run).

        A disaggregated fleet routes by queue depth over the decode tier
        and stages the prompt's prefix first (``_stage_prefix``).
        ``speculative=True`` (batch/best_effort) runs the fused
        speculative path on the decode replica and skips staging.
        """
        tokens: list[int] = []
        path: list[str] = []
        tried: set[str] = set()
        disagg = self.roles is not None
        while True:
            budget = max_new_tokens - len(tokens)
            if budget <= 0:
                return tokens, {"replicas": path,
                                "migrations": len(path) - 1}
            full = prompt + tokens
            try:
                name = (self._route_decode(exclude=tried or None)
                        if disagg else
                        self.route(full, session, exclude=tried or None))
            except NoReadyReplica:
                return None, {"replicas": path, "reason": "no_replica"}
            gw = self.gateways.get(name)
            if gw is None:
                # lost the race with remove_replica: re-resolve from the
                # CURRENT ring, never submit to a replica being removed
                tried.add(name)
                continue
            chain = None
            if (disagg and self.store is not None and not speculative
                    and gw.engine.paged):
                chain = self._stage_prefix(gw, full)
            try:
                pending, reason = gw.try_submit(
                    tenant, full, max_new_tokens=budget, eos_id=eos_id,
                    slo_class=slo_class, speculative=speculative,
                    chain=chain)
            except ValueError:
                # a resume prompt can overflow slot_len where the
                # original fit: bucket(Tp + tokens so far) may round up
                # to the next power of two while the budget shrinks by
                # less. Greedy decode from the original prompt gives the
                # same tokens: pay the decode again, never fail it
                if not tokens:
                    raise
                tokens = []
                continue
            if pending is None:
                if reason in ("rate", "tokens"):
                    # a tenant's budget is fleet policy, not replica
                    # pressure: spilling would launder the quota
                    return None, {"replicas": path, "reason": reason}
                tried.add(name)     # queue/slo/draining: try elsewhere
                continue
            path.append(name)
            try:
                tokens.extend(gw.wait(pending, timeout_s))
                return tokens, {"replicas": path,
                                "migrations": len(path) - 1}
            except ReplicaUnavailable as e:
                tokens.extend(e.tokens_so_far)
                self.migrations += 1
                cp_metrics.SERVING_MIGRATIONS_TOTAL.inc()
                tried.add(name)
                # eos may have landed just before the replica let go
                if eos_id is not None and tokens and tokens[-1] == eos_id:
                    return tokens, {"replicas": path,
                                    "migrations": len(path) - 1}

    # -- observability -----------------------------------------------------

    def snapshot(self) -> dict:
        states = self.states()
        self._publish_tiers()
        return {
            "replicas": {
                name: {
                    "state": states[name],
                    "role": self.roles[name] if self.roles else None,
                    "queue_depth": gw.engine.queue_depth,
                    "active_slots": gw.engine.active_slots,
                    "prefix_hit_ratio": gw.engine.stats().get(
                        "prefix_hit_ratio"),
                }
                for name, gw in sorted(self.gateways.items())
            },
            "migrations": self.migrations,
            "spills": self.spills,
            "handoffs": self.handoffs,
            "prefix_tokens": self.prefix_tokens,
            "roles": dict(self.roles) if self.roles else None,
            "store": self.store.stats() if self.store else None,
        }

    def close(self) -> None:
        for name, gw in self.gateways.items():
            if self._state[name] != DEAD:
                gw.close()


def make_fleet_app(fleet: ServingFleet, cfg):
    """The WSGI front door over the whole fleet (standard library only):
    what an external load balancer points at. ``POST /generate`` takes
    the single-replica fields plus ``session`` (stickiness) and
    ``slo_class``; ``GET /api/fleet`` is the operators' view; ``GET
    /api/store`` the store's counters and ``GET /api/store/chain/<hex
    key>`` one chain as ``chain_to_bytes`` (how a decode replica in
    another process adopts a prefix); ``POST /replicas/<name>/drain`` is
    the preStop hook."""

    def app(environ, start_response):
        path = environ.get("PATH_INFO", "")
        try:
            if path == "/healthz":
                states = fleet.states()
                ready = sum(1 for s in states.values() if s == READY)
                return respond(start_response, 200 if ready else 503,
                               {"ok": bool(ready), "ready": ready,
                                "replicas": states})
            if path == "/api/fleet":
                return respond(start_response, 200, fleet.snapshot())
            if path == "/api/store":
                if fleet.store is None:
                    return respond(start_response, 200, {"enabled": False})
                return respond(start_response, 200,
                               {"enabled": True, **fleet.store.stats()})
            if path.startswith("/api/store/chain/"):
                if fleet.store is None:
                    raise HTTPError(404, "fleet has no global block store")
                try:
                    key = bytes.fromhex(path[len("/api/store/chain/"):])
                except ValueError:
                    raise HTTPError(400, "key must be hex") from None
                got = fleet.store.get_chain(key)
                if got is None:
                    raise HTTPError(404, "no chain holds that prefix key")
                return respond(start_response, 200, chain_to_bytes(got),
                               content_type="application/octet-stream")
            if path == "/metrics":
                return respond(start_response, 200, cp_metrics.scrape(),
                               content_type="text/plain; version=0.0.4")
            parts = path.split("/")
            if len(parts) == 4 and parts[1] == "replicas" \
                    and parts[3] == "drain":
                require_method(environ, "POST")
                if parts[2] not in fleet.gateways:
                    raise HTTPError(404, f"no replica {parts[2]}")
                fleet.drain(parts[2])
                return respond(start_response, 200, {"draining": parts[2]})
            if path != "/generate":
                raise HTTPError(404, f"no route {path}")
            require_method(environ, "POST")
            body = read_json(environ)
            req = parse_generate(body, cfg)
            session = body.get("session")
            if session is not None and (not isinstance(session, str)
                                        or len(session) > 128):
                raise HTTPError(400, "session must be a short string")
            try:
                tokens, info = fleet.submit_and_wait(
                    tenant_of(body, environ), req["prompt"],
                    max_new_tokens=req["max_new_tokens"],
                    eos_id=body.get("eos_id"), slo_class=req["slo_class"],
                    session=session, speculative=req["speculative"])
            except ValueError as e:
                raise HTTPError(400, str(e)) from None
            if tokens is None:
                return shed_response(start_response, info.get("reason"))
            return respond(start_response, 200, {"tokens": tokens, **info})
        except HTTPError as e:
            return respond(start_response, e.status, {"error": str(e)})

    app.fleet = fleet
    return app
