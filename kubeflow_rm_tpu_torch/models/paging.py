"""Block-paged KV cache with copy-on-write prefix sharing (counterpart of
``kubeflow_rm_tpu/models/paging.py``).

The cache is one pool of fixed-size **blocks** (``block_size`` tokens
each) and every decode slot owns a **block table**, a row of block ids
whose concatenation is that slot's logical KV strip of ``slot_len``
positions:

- **Prefix sharing.** Blocks are content-addressed by chained hashes of
  the prompt (``prefix_keys``): identical prefixes resolve to the same
  blocks, which later requests adopt (refcounted) instead of prefilling.
  Shared blocks are never written; a request whose first write lands
  inside a shared, partly filled block gets its own copy of it first
  (copy-on-write, ``BlockPool.cow_forks``).
- **Packing.** Short requests hold few blocks, retired blocks return to
  the free list, and registered prefix blocks at refcount 0 are retained
  in an LRU until an allocation needs them.

Two blocks are reserved: ``NULL_BLOCK`` (all-``_UNFILLED`` positions,
the gather target of unassigned table entries, never written) and
``SINK_BLOCK`` (where writes that must go nowhere land: inactive rows'
decode writes and install chunks that belong to shared blocks). Several
inactive rows may write the sink in one step; which of them lands is
unspecified, which is harmless only because nothing reads the sink.

Where the JAX package returns a new cache, the port writes the pool IN
PLACE, with one exception: ``paged_prefill`` treats the pool as
read-only and computes into a fresh temporary strip, because a borrowed
source block may still hold another slot's live tokens past the shared
prefix. ``paged_install`` then overwrites every owned block whole,
positions included — that is the no-stale-reads guarantee for recycled
blocks.

The decode step gathers each slot's strip one layer at a time, inside
the trunk's ``write_kv`` hook, and scatters back only the written
column: the values are those of JAX's all-layer gather, at 1/L of its
transient memory.

``BlockPool`` and ``prefix_keys`` are host-only and copied from the JAX
package. Chains (``export_chain``) carry their chunks as numpy arrays;
numpy has no bfloat16, so bf16 chunks travel as ``uint16`` bit patterns
and ``_chunk_checksum`` hashes the same bytes a JAX bf16 array holds.
"""

from __future__ import annotations

import hashlib
import logging
from collections import OrderedDict, deque
from dataclasses import dataclass

import numpy as np
import torch

from kubeflow_rm_tpu_torch.models.generate import _UNFILLED, _run_blocks
from kubeflow_rm_tpu_torch.models.llama import LlamaConfig

_log = logging.getLogger(__name__)

#: reserved block ids (see module docstring)
NULL_BLOCK = 0
SINK_BLOCK = 1
RESERVED_BLOCKS = 2


# ---------------------------------------------------------------------------
# device state
# ---------------------------------------------------------------------------


@dataclass
class PagedKVCache:
    """Pool-of-blocks KV state. ``block_tables[i]`` concatenated is slot
    *i*'s logical strip of ``slot_len = MAXB * BS`` positions;
    ``write_idx``/``pos_next`` are the per-slot counters ``SlotCache``
    keeps, in logical-strip offsets."""
    k: torch.Tensor             # (L, NB, BS, KVH, hd) compute dtype
    v: torch.Tensor             # (L, NB, BS, KVH, hd)
    positions: torch.Tensor     # (NB, BS) int32; _UNFILLED marks empty
    block_tables: torch.Tensor  # (SLOTS, MAXB) int64; NULL_BLOCK = unset
    write_idx: torch.Tensor     # (SLOTS,) int32: next logical write slot
    pos_next: torch.Tensor      # (SLOTS,) int32: next token position


def init_paged_cache(cfg: LlamaConfig, slots: int, slot_len: int,
                     num_blocks: int, block_size: int,
                     device: str | torch.device | None = None
                     ) -> PagedKVCache:
    from kubeflow_rm_tpu_torch.device import default_device

    if slot_len % block_size:
        raise ValueError(f"slot_len {slot_len} must be a multiple of "
                         f"block_size {block_size}")
    if num_blocks <= RESERVED_BLOCKS:
        raise ValueError(f"num_blocks {num_blocks} leaves no usable "
                         f"blocks ({RESERVED_BLOCKS} are reserved)")
    device = default_device(device)
    L, KVH, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    maxb = slot_len // block_size
    shape = (L, num_blocks, block_size, KVH, hd)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        positions=torch.full((num_blocks, block_size), _UNFILLED,
                             dtype=torch.int32, device=device),
        block_tables=torch.full((slots, maxb), NULL_BLOCK,
                                dtype=torch.long, device=device),
        write_idx=torch.zeros((slots,), dtype=torch.int32, device=device),
        pos_next=torch.zeros((slots,), dtype=torch.int32, device=device),
    )


def _ids(ids, device) -> torch.Tensor:
    """Block ids (a list or a tensor) as an int64 index on ``device``."""
    return torch.as_tensor(ids, dtype=torch.long, device=device)


# ---------------------------------------------------------------------------
# device ops
# ---------------------------------------------------------------------------


@torch.no_grad()
def paged_decode_step(params, cfg, cache: PagedKVCache, tokens, active):
    """One decode step over every slot, against gathered block views.

    Mirrors ``slot_decode_step``: each active row attends at its own
    ``pos_next`` over its gathered (slot_len-long) strip and writes K/V
    at its own ``write_idx``; inactive rows flow through with query
    position ``_UNFILLED`` and their pool write diverted to SINK_BLOCK
    (their table may name blocks that other slots now own). ``tokens``
    (B,) int32 and ``active`` (B,) bool; the pool is written in place.
    Returns (last-position logits (B, V) float32, the cache).
    """
    B, MAXB = cache.block_tables.shape
    BS = cache.positions.shape[1]
    S = MAXB * BS
    rows = torch.arange(B, device=tokens.device)

    positions = torch.where(active, cache.pos_next, _UNFILLED)[:, None]
    # the JAX step clamps here (paging.py:130); an out-of-range index
    # on CUDA would be a device-side assert, not a dropped write
    wi = cache.write_idx.long().clamp(0, S - 1)
    blk = torch.where(active, cache.block_tables[rows, wi // BS],
                      SINK_BLOCK)
    off = wi % BS
    tables = cache.block_tables

    kv_positions = cache.positions[tables].reshape(B, S)
    kv_positions[rows, wi] = positions[:, 0]
    cache.positions[blk, off] = positions[:, 0]

    def write_kv(i, k, v):
        # layer i's strips, gathered from the pool before this step's
        # write; then only the written column goes back to the pool
        gk = cache.k[i][tables].reshape(B, S, *cache.k.shape[3:])
        gv = cache.v[i][tables].reshape(B, S, *cache.v.shape[3:])
        gk[rows, wi] = k[:, 0]
        gv[rows, wi] = v[:, 0]
        cache.k[i][blk, off] = k[:, 0]
        cache.v[i][blk, off] = v[:, 0]
        return gk, gv

    logits = _run_blocks(params, cfg, tokens[:, None], positions,
                         kv_positions, write_kv)
    inc = active.to(torch.int32)
    cache.write_idx += inc
    cache.pos_next += inc
    return logits[:, -1, :], cache


@torch.no_grad()
def paged_prefill(params, cfg, cache: PagedKVCache, load_row, n_hit: int,
                  tokens, n_real: int):
    """Prefill one request's suffix against its cached prefix.

    ``load_row`` (MAXB,) names the SOURCE blocks of the shared prefix
    (NULL beyond it); the gathered strip is truncated to ``n_hit``
    tokens — everything from ``n_hit`` on reads ``_UNFILLED``, since a
    partly reused source block may carry another request's live tokens
    past the shared region. ``tokens`` (1, Tc) is the right-padded
    suffix whose first ``n_real`` columns are real; it runs at offsets
    ``n_hit .. n_hit + Tc``. The pool is only read. Returns the last
    real token's logits (V,) and the temporary strip (k (L, 1, S, KVH,
    hd), v, positions (1, S)) for ``paged_install`` to carve into
    blocks. Raises if the suffix does not fit the strip.
    """
    L = cache.k.shape[0]
    load_row = _ids(load_row, cache.k.device)
    MAXB, BS = load_row.shape[0], cache.positions.shape[1]
    S = MAXB * BS
    Tc = tokens.shape[1]
    if n_hit + Tc > S:
        raise ValueError(f"suffix of {Tc} at offset {n_hit} overflows the "
                         f"strip of {S}")

    tk = cache.k[:, load_row].reshape(L, 1, S, *cache.k.shape[3:])
    tv = cache.v[:, load_row].reshape(L, 1, S, *cache.v.shape[3:])
    kv_positions = cache.positions[load_row].reshape(1, S)
    kv_positions[:, n_hit:] = _UNFILLED
    cols = torch.arange(Tc, dtype=torch.int32, device=tokens.device)
    positions = torch.where(cols < n_real, n_hit + cols, _UNFILLED)[None]
    kv_positions[:, n_hit:n_hit + Tc] = positions

    def write_kv(i, k, v):
        tk[i, :, n_hit:n_hit + Tc] = k
        tv[i, :, n_hit:n_hit + Tc] = v
        return tk[i], tv[i]

    logits = _run_blocks(params, cfg, tokens, positions, kv_positions,
                         write_kv)
    return logits[0, n_real - 1, :], tk, tv, kv_positions


@torch.no_grad()
def paged_install(cache: PagedKVCache, temp_k, temp_v, temp_pos, slot: int,
                  final_row, dest_row, write_idx0: int) -> PagedKVCache:
    """Carve a prefilled temporary strip into pool blocks and activate
    the slot, in place. ``dest_row`` (MAXB,) maps each strip chunk to
    its pool destination: the request's OWN blocks for owned chunks,
    SINK for chunks it shares (already in the pool — a shared block is
    never overwritten) and for tail chunks past its allocation. Every
    owned block is overwritten whole, positions included, so whatever a
    recycled block held before, its visible state is now the fresh
    strip's. ``write_idx0`` seats both counters at the real prompt
    length."""
    L = cache.k.shape[0]
    dest_row = _ids(dest_row, cache.k.device)
    MAXB, BS = dest_row.shape[0], cache.positions.shape[1]
    cache.k[:, dest_row] = temp_k[:, 0].reshape(L, MAXB, BS,
                                                *temp_k.shape[3:])
    cache.v[:, dest_row] = temp_v[:, 0].reshape(L, MAXB, BS,
                                                *temp_v.shape[3:])
    cache.positions[dest_row] = temp_pos[0].reshape(MAXB, BS)
    cache.block_tables[slot] = _ids(final_row, cache.k.device)
    cache.write_idx[slot] = write_idx0
    cache.pos_next[slot] = write_idx0
    return cache


@torch.no_grad()
def gather_slot_strip(cache: PagedKVCache, slot: int):
    """Debug/test helper: slot ``slot``'s logical strip as contiguous
    (k (L, S, KVH, hd), v, positions (S,)) copies."""
    row = cache.block_tables[slot]
    L = cache.k.shape[0]
    MAXB, BS = row.shape[0], cache.positions.shape[1]
    k = cache.k[:, row].reshape(L, MAXB * BS, *cache.k.shape[3:])
    v = cache.v[:, row].reshape(L, MAXB * BS, *cache.v.shape[3:])
    return k, v, cache.positions[row].reshape(MAXB * BS)


# ---------------------------------------------------------------------------
# host-side block accounting (copied from the JAX package)
# ---------------------------------------------------------------------------


def prefix_keys(tokens, block_size: int) -> list[tuple[int, bytes]]:
    """Chained content keys for a prompt: one per full-block boundary
    plus one for the trailing partial block. Key *i* digests
    ``tokens[: covered_i]`` — the whole prefix, not just the block —
    because a block's K/V depends on every token before it. Returns
    ``[(covered_tokens, key), ...]`` in chain order."""
    out: list[tuple[int, bytes]] = []
    arr = np.asarray(list(tokens), np.int32)
    h = hashlib.blake2b(digest_size=16)
    full = len(arr) // block_size
    for c in range(full):
        h.update(arr[c * block_size:(c + 1) * block_size].tobytes())
        out.append(((c + 1) * block_size, b"f" + h.digest()))
    if len(arr) % block_size:
        hp = h.copy()
        hp.update(arr[full * block_size:].tobytes())
        out.append((len(arr), b"p" + hp.digest()))
    return out


class BlockPool:
    """Refcounted free-list + content-addressed prefix index over the
    pool's block ids. Host-side only, driven by the single engine
    thread — no lock here.

    Lifecycle of a block: ``alloc`` (ref=1) → optionally ``register``
    under a prefix key (content-addressed, sharable) → ``incref`` per
    additional table that adopts it → ``decref`` per retiring table.
    At ref 0 an *unregistered* block returns to the free list
    immediately; a *registered* block is retained as prefix cache and
    only evicted — oldest first — when ``alloc`` runs dry. ``alloc``
    is atomic: it either returns ``n`` blocks or returns ``None``
    having changed nothing (the clean-OOM contract admission relies
    on)."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks <= RESERVED_BLOCKS:
            raise ValueError(
                f"num_blocks {num_blocks} leaves no usable blocks")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free: deque[int] = deque(range(RESERVED_BLOCKS,
                                             num_blocks))
        self._ref: dict[int, int] = {}
        self._index: OrderedDict[bytes, int] = OrderedDict()
        self._block_key: dict[int, bytes] = {}
        # chain linkage for registered keys: key -> predecessor key
        # (None at the chain head) and key -> covered-token count
        self._parent: dict[bytes, bytes | None] = {}
        self._covered: dict[bytes, int] = {}
        #: optional ``fn(key, block)`` called just before a retained
        #: ref-0 prefix block is evicted, while its content is still
        #: in the device pool
        self.on_evict = None
        self.cow_forks = 0
        self.evictions = 0
        self.alloc_failures = 0
        self.evict_hook_errors = 0

    # -- capacity ------------------------------------------------------

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - RESERVED_BLOCKS

    def free_count(self) -> int:
        return len(self._free)

    def evictable_count(self) -> int:
        return sum(1 for b in self._block_key
                   if self._ref.get(b, 0) == 0)

    def available(self) -> int:
        """Blocks an alloc could hand out right now: free + evictable
        retained prefix blocks."""
        return self.free_count() + self.evictable_count()

    def ref_of(self, block: int) -> int:
        return self._ref.get(block, 0)

    # -- alloc / refcount ----------------------------------------------

    def alloc(self, n: int) -> list[int] | None:
        """``n`` blocks at ref 1, or ``None`` with NO state change."""
        if n <= 0:
            return []
        if self.available() < n:
            self.alloc_failures += 1
            return None
        out: list[int] = []
        while len(out) < n:
            if self._free:
                b = self._free.popleft()
            else:
                b = self._evict_one()
            self._ref[b] = 1
            out.append(b)
        return out

    def _evict_one(self) -> int:
        for key, b in self._index.items():     # oldest entry first
            if self._ref.get(b, 0) == 0:
                if self.on_evict is not None:
                    # the hook reads the block from the device pool, so
                    # it runs BEFORE the id is handed out again; a
                    # failing hook must never break alloc
                    try:
                        self.on_evict(key, b)
                    except Exception:
                        self.evict_hook_errors += 1
                        _log.warning("on_evict hook failed; block %d "
                                     "evicted without it", b,
                                     exc_info=True)
                del self._index[key]
                del self._block_key[b]
                self._parent.pop(key, None)
                self._covered.pop(key, None)
                self.evictions += 1
                return b
        raise RuntimeError("evict with no evictable block "
                           "(available() said otherwise)")

    def incref(self, blocks) -> None:
        for b in blocks:
            self._ref[b] = self._ref.get(b, 0) + 1
            key = self._block_key.get(b)
            if key is not None:                # LRU touch
                self._index.move_to_end(key)

    def decref(self, blocks) -> None:
        for b in blocks:
            r = self._ref.get(b, 0) - 1
            if r < 0:
                raise RuntimeError(f"decref of block {b} below zero")
            self._ref[b] = r
            if r == 0 and b not in self._block_key:
                self._free.append(b)

    # -- prefix index --------------------------------------------------

    def lookup(self, key: bytes) -> int | None:
        b = self._index.get(key)
        if b is not None:
            self._index.move_to_end(key)
        return b

    def register(self, key: bytes, block: int, *,
                 parent: bytes | None = None,
                 covered: int | None = None) -> int:
        """Publish ``block`` under ``key``; first writer wins (an
        identical prefix prefilled twice registers once — the second
        block simply frees on retire). ``parent``/``covered`` record
        the chain linkage."""
        if parent is not None or key not in self._parent:
            self._parent[key] = parent
        if covered is not None:
            self._covered[key] = int(covered)
        existing = self._index.get(key)
        if existing is not None:
            self._index.move_to_end(key)
            return existing
        if block in self._block_key:           # one key per block
            return self._index[self._block_key[block]]
        self._index[key] = block
        self._block_key[block] = key
        return block

    def parent_of(self, key: bytes) -> bytes | None:
        return self._parent.get(key)

    def covered_of(self, key: bytes) -> int | None:
        return self._covered.get(key)

    def lookup_chain(self, keys) -> list[int]:
        """Longest CONSECUTIVE run of ``keys`` present in the index
        (a later hit without its predecessors is unusable — the table
        needs every chunk up to the hit). Returns the blocks."""
        out: list[int] = []
        for _covered, key in keys:
            b = self.lookup(key)
            if b is None:
                break
            out.append(b)
        return out

    def stats(self) -> dict:
        return {
            "blocks_total": self.usable_blocks,
            "blocks_free": self.free_count(),
            "blocks_evictable": self.evictable_count(),
            "blocks_available": self.available(),
            "free_block_fraction": (self.available()
                                    / max(1, self.usable_blocks)),
            "prefix_entries": len(self._index),
            "cow_forks": self.cow_forks,
            "evictions": self.evictions,
            "alloc_failures": self.alloc_failures,
        }


# ---------------------------------------------------------------------------
# chain export / import — replica-to-replica block transfer
# ---------------------------------------------------------------------------
# The chained ``prefix_keys`` hashes commit to the whole prefix, so a
# chain names its K/V content: any pool that prefilled the same tokens
# on the same weights holds the same blocks under the same keys. A
# serialized chain carries host copies of those blocks plus per-chunk
# checksums; ``import_chain`` refuses a corrupted chunk without touching
# pool state.


def to_host(t: torch.Tensor) -> np.ndarray:
    """A cache tensor as a numpy array of its own (a copy, never a view
    of the pool: a CPU tensor's ``.cpu()`` is the tensor itself); bf16
    as its ``uint16`` bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_host(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """Inverse of ``to_host``: ``uint16`` arrays (and the JAX package's
    numpy bfloat16) are bf16 bit patterns; the result is cast to
    ``dtype`` on ``device``."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint16 or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def _chunk_checksum(ck: np.ndarray, cv: np.ndarray,
                    cp: np.ndarray) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(ck).tobytes())
    h.update(np.ascontiguousarray(cv).tobytes())
    h.update(np.ascontiguousarray(cp).tobytes())
    return h.digest()


def export_block_chunk(cache: PagedKVCache, block: int,
                       valid: int) -> dict:
    """Host copy of ONE pool block, sanitized past ``valid`` tokens
    (zero K/V, ``_UNFILLED`` positions) so the bytes — and therefore
    the checksum — depend only on the prefix the block's key names."""
    ck = to_host(cache.k[:, block])            # (L, BS, KVH, hd)
    cv = to_host(cache.v[:, block])
    cp = to_host(cache.positions[block])
    ck[:, valid:] = 0
    cv[:, valid:] = 0
    cp[valid:] = _UNFILLED
    return {"k": ck, "v": cv, "pos": cp,
            "sum": _chunk_checksum(ck, cv, cp)}


def export_chain(cache: PagedKVCache, pool: BlockPool,
                 tokens) -> dict | None:
    """Serialize the pool's chain for ``tokens`` — every chunk's K/V,
    positions, keys and checksums — or ``None`` if the pool does not
    hold the full chain. Tail columns past each chunk's covered count
    are sanitized, so identical prompts export identical bytes."""
    tokens = [int(t) for t in tokens]
    keys = prefix_keys(tokens, pool.block_size)
    blocks = pool.lookup_chain(keys)
    if len(blocks) < len(keys):
        return None
    BS = pool.block_size
    idx = _ids(blocks, cache.k.device)
    ck = to_host(cache.k[:, idx])              # (L, NC, BS, KVH, hd)
    cv = to_host(cache.v[:, idx])
    cp = to_host(cache.positions[idx])
    for i, (covered, _key) in enumerate(keys):
        valid = covered - i * BS
        ck[:, i, valid:] = 0
        cv[:, i, valid:] = 0
        cp[i, valid:] = _UNFILLED
    sums = [_chunk_checksum(ck[:, i], cv[:, i], cp[i])
            for i in range(len(keys))]
    return {
        "version": 1,
        "block_size": BS,
        "tokens": tokens,
        "covered": keys[-1][0],
        "keys": [k for _c, k in keys],
        "covers": [c for c, _k in keys],
        "chunks_k": ck,
        "chunks_v": cv,
        "chunks_pos": cp,
        "sums": sums,
        "nbytes": int(ck.nbytes + cv.nbytes + cp.nbytes),
    }


def verify_chain(chain: dict) -> None:
    """Raise ``ValueError`` unless the chain is internally consistent:
    chunk checksums match the payload, and — when the prompt rides
    along — the keys really are the chained hashes of the tokens.
    Checks mutate nothing, so a refusal leaves any pool untouched."""
    keys = list(chain.get("keys") or [])
    covers = list(chain.get("covers") or [])
    sums = list(chain.get("sums") or [])
    nc = len(keys)
    if not nc or len(covers) != nc or len(sums) != nc:
        raise ValueError("chain integrity: malformed key/cover/sum "
                         "lists")
    ck, cv, cp = (chain["chunks_k"], chain["chunks_v"],
                  chain["chunks_pos"])
    BS = int(chain["block_size"])
    if (ck.shape[1] != nc or cv.shape != ck.shape
            or cp.shape != (nc, BS) or ck.shape[2] != BS):
        raise ValueError("chain integrity: chunk shapes disagree "
                         "with the key list")
    tokens = chain.get("tokens")
    if tokens is not None:
        want = prefix_keys(tokens, BS)
        if ([k for _c, k in want] != keys
                or [c for c, _k in want] != covers):
            raise ValueError("chain integrity: keys are not the "
                             "chained hashes of the tokens")
    for i in range(nc):
        if _chunk_checksum(ck[:, i], cv[:, i], cp[i]) != sums[i]:
            raise ValueError(
                f"chain integrity: chunk {i} checksum mismatch")


def seat_chunks(cache: PagedKVCache, blocks, chain: dict) -> None:
    """Write a verified chain's chunks into pool ``blocks``, in place."""
    idx = _ids(blocks, cache.k.device)
    cache.k[:, idx] = from_host(chain["chunks_k"], cache.k.dtype,
                                cache.k.device)
    cache.v[:, idx] = from_host(chain["chunks_v"], cache.v.dtype,
                                cache.v.device)
    cache.positions[idx] = from_host(chain["chunks_pos"], torch.int32,
                                     cache.k.device)


def import_chain(cache: PagedKVCache, pool: BlockPool,
                 chain: dict) -> tuple[PagedKVCache, list[int]] | None:
    """Adopt a foreign chain: verify it, seat its chunks in freshly
    allocated blocks (in place), and register every key. Returns the
    cache plus the allocated blocks (ref 1 — the caller decrefs them to
    hand the chain to the LRU as retained prefix cache), or ``None`` on
    clean OOM. Keys already registered locally keep their existing
    blocks; the redundant fresh block simply frees on decref."""
    verify_chain(chain)
    if int(chain["block_size"]) != pool.block_size:
        raise ValueError(
            f"chain block_size {chain['block_size']} != pool "
            f"block_size {pool.block_size}")
    if chain["chunks_k"].shape[0] != cache.k.shape[0] \
            or tuple(chain["chunks_k"].shape[2:]) != tuple(cache.k.shape[2:]):
        raise ValueError("chain chunk shape does not fit this cache")
    blocks = pool.alloc(len(chain["keys"]))
    if blocks is None:
        return None
    seat_chunks(cache, blocks, chain)
    parent = None
    for i, key in enumerate(chain["keys"]):
        pool.register(key, blocks[i], parent=parent,
                      covered=chain["covers"][i])
        parent = key
    return cache, blocks
