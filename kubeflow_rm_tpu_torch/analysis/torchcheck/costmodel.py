"""Per-op FLOPs/bytes cost model and live-range peak-memory estimator
over eager PyTorch programs (counterpart of
``kubeflow_rm_tpu/analysis/jaxcheck/costmodel.py``).

``estimate(fn, *args, donate_argnums=...)`` runs ``fn`` on meta tensors
(shapes, dtypes and strides, no memory: a 7B train step costs seconds
of CPU) under a ``TorchDispatchMode`` that sees every aten op the
program executes:

- **FLOPs**: ``mm``/``bmm``/``addmm``/``baddbmm``/``_scaled_mm`` at
  2·M·N·K (plus the add of the ``add`` forms), elementwise ops at one
  flop per output element (a softmax at JAX's five: max, sub, exp, sum,
  div), reductions at one per input element, data movement at none — the
  per-primitive table of JAX's ``_leaf_cost``. A Python loop is walked
  as it runs, so the remat recompute of the backward counts as executed,
  as in JAX; ``utils.flops`` stays the MFU convention.
- **Traffic**: operand plus result bytes per op, an upper bound that
  ignores fusion.
- **Peak**: a live-bytes tally of storages, from the op that allocates
  one to the moment its last reference dies (a ``weakref.finalize`` on
  the storage), each rounded up to the caching allocator's 512-byte
  granularity.

**Donation in an eager program.** The port's train step updates its
state in place, which is what JAX's buffer donation buys. So: a
non-donated argument stays resident for the whole call; a donated one
is freed when its storage dies; and in the no-donation column an
in-place write to an argument counts as a fresh buffer of its size
(the caller still holds the old value), once per argument. For the
in-place optimizer step ``peak_bytes_no_donation - peak_bytes`` is then
the state the update writes, where the update's phase holds the peak.

**The card's path, without a card.** The walk's tensors live on the
meta device, not on a fake CUDA device: a CPU-only build of torch runs
fake CUDA tensors forward but aborts in autograd (it has no CUDA device
guard), and ``FakeTensorMode``'s per-op cache keys would triple the
walk. So the walk sets ``ops.attention.as_device("cuda")``
(``as_device=``), under which attention takes the path it takes on the
card: the custom ops ``kfrm::flash_attention`` /
``kfrm::flash_attention_bwd``, whose registered fake implementations
give their outputs. Their FLOPs are what JAX's walk counts for the same
attention (its XLA path: two products over the full T×T per head, and
their gradients), that is, the FLOPs of the port's dense attention at
the same shapes, walked once per shape; so a walk of the card's path
and of the CPU's plain path count the same FLOPs. Their bytes are their
own operands and results; the backward's float32 δ temporaries count as
scratch.

**Regions.** The spans the program opens (``utils.profiling.annotate``:
the train step's ``train.microbatch``) are reported with their own FLOPs
(``estimate(..., regions=)``): the memory planner walks two microbatches
of an accumulation and counts the rest from the second one's, as JAX's
walk multiplies a scan body by its trip count.

Approximations: fusion is ignored (every op's temporaries count while
alive); the cuBLAS workspace is not modelled; ops outside the tables
count bytes but zero flops and are tallied in ``unknown_primitives``,
never dropped. ``while_loops`` is always 0: an eager loop is walked
trip by trip.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import threading
import weakref
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kubeflow_rm_tpu_torch.utils.profiling import observe
from kubeflow_rm_tpu_torch.utils.pytree import tree_leaves

#: the caching allocator's granularity: every block is a multiple
ALLOC_ROUND = 512

_MATMUL = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm",
                     "_scaled_mm", "mv", "dot", "addmv"})

# pure data movement, layout and bookkeeping: bytes, no flops
_MOVEMENT = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "t", "transpose",
    "permute", "expand", "slice", "select", "unsqueeze", "squeeze",
    "clone", "copy", "_to_copy", "to", "detach", "alias", "as_strided",
    "cat", "stack", "split", "split_with_sizes", "unbind", "chunk",
    "narrow", "roll", "flip", "repeat", "diagonal", "index",
    "index_select", "gather", "scatter", "scatter_add", "index_add",
    "index_put", "_unsafe_index", "_unsafe_index_put", "embedding",
    "embedding_dense_backward", "slice_backward", "select_backward",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "new_zeros", "new_ones", "new_full", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "fill",
    "zero", "arange", "scalar_tensor", "lift_fresh", "lift_fresh_copy",
    "_local_scalar_dense", "randn", "rand", "randint", "normal",
    "uniform", "bernoulli", "random", "set", "resize", "view_as_real",
    "view_as_complex", "_pin_memory", "record_stream",
    # the port's tag of a named remat activation (a copy)
    "checkpoint_name",
})

# one flop per output element (arithmetic, comparisons, selects,
# transcendentals: the table is flat, as JAX's)
_ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "neg",
    "abs", "sign", "reciprocal", "sqrt", "rsqrt", "exp", "exp2", "expm1",
    "log", "log1p", "log2", "sin", "cos", "tan", "tanh", "sigmoid",
    "erf", "erfc", "floor", "ceil", "round", "trunc", "pow", "square",
    "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "where",
    "masked_fill", "eq", "ne", "lt", "le", "gt", "ge", "logical_and",
    "logical_or", "logical_not", "logical_xor", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "isfinite", "isnan",
    "isinf", "nan_to_num", "relu", "threshold_backward", "atan2",
    "floor_divide", "tril", "triu", "gelu",
})

# several flops per output element: (JAX's lowering) silu = x ·
# logistic(x); addcmul/addcdiv/lerp two ops; a softmax max, sub, exp,
# sum, div; its gradient mul, sum, sub, mul
_PER_ELEMENT = {
    "silu": 2, "silu_backward": 4, "sigmoid_backward": 2,
    "tanh_backward": 2, "gelu_backward": 4, "addcmul": 2, "addcdiv": 2,
    "lerp": 2, "cumsum": 2, "cumprod": 2, "_softmax": 5,
    "_log_softmax": 5, "_softmax_backward_data": 4,
    "_log_softmax_backward_data": 4,
}

# one flop per INPUT element
_REDUCTION = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "prod", "any", "all", "norm", "linalg_vector_norm", "var", "std",
    "logsumexp", "topk", "sort", "nll_loss_forward", "nll_loss_backward",
})

# the port's custom ops, costed as the dense attention they replace
_FLASH = frozenset({"flash_attention", "flash_attention_bwd"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rounded(n: int) -> int:
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


@functools.lru_cache(maxsize=None)
def _op_info(func) -> tuple:
    """(namespace, base name, kind, positions and names of the arguments
    the op writes) of an op overload; in-place and out forms share the
    base name (``aten.add_.Tensor`` -> ``add``)."""
    name = func.overloadpacket.__name__
    if name.endswith("_") and name[:-1] and name not in _MOVEMENT:
        name = name[:-1]
    ns = func.namespace
    if ns == "kfrm" and name in _FLASH:
        kind = "flash"
    elif ns == "profiler":
        kind = "marker"
    elif name in _MATMUL:
        kind = "matmul"
    elif name in _ELEMENTWISE:
        kind = "elementwise"
    elif name in _PER_ELEMENT:
        kind = "per_element"
    elif name in _REDUCTION:
        kind = "reduction"
    elif name in _MOVEMENT:
        kind = "movement"
    else:
        kind = "unknown"
    writes = tuple((i, a.name) for i, a in enumerate(func._schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write)
    return ns, name, kind, writes


def _matmul_flops(name: str, args) -> float:
    """2·M·N·K per product (times the batch), plus the M·N add of the
    ``add`` forms."""
    if name == "dot":
        return 2.0 * args[0].numel()
    a, b = args[1:3] if name.startswith(("add", "badd")) else args[:2]
    if name in ("mv", "addmv"):
        batch, (m, k), n = 1, a.shape, 1
    else:
        batch = a.shape[0] if a.dim() == 3 else 1
        (m, k), n = a.shape[-2:], b.shape[-1]
    flops = 2.0 * batch * m * n * k
    if name in ("addmm", "addmv", "baddbmm"):
        flops += batch * m * n
    elif name == "addbmm":
        flops += m * n
    return flops


def _flash_key(name: str, args) -> tuple:
    """The dense-attention shape a flash op call stands for:
    (backward?, B, H, KVH, T, D, causal, segments?, dtype)."""
    if name == "flash_attention":
        q, k, _v, segq, _segkv, heads, group, causal = args[:8]
    else:
        _do, q, k, _v, segq, _segkv, _out, _lse, heads, group, causal = \
            args[:11]
    BH, T, D = q.shape
    return (name == "flash_attention_bwd", BH // heads, heads,
            heads // group, T, D, bool(causal), segq is not None, q.dtype)


@functools.lru_cache(maxsize=None)
def _dense_attention_flops(key: tuple) -> float:
    """FLOPs of the port's dense attention at a flash op's shapes: its
    forward for ``kfrm::flash_attention``, the gradient of q, k and v for
    ``kfrm::flash_attention_bwd`` — JAX's count of the same attention."""
    from kubeflow_rm_tpu_torch.ops.attention import dot_product_attention

    backward, B, H, KVH, T, D, causal, seg, dtype = key
    meta = dict(dtype=dtype, device="meta", requires_grad=True)
    q = torch.empty(B, T, H, D, **meta)
    k = torch.empty(B, T, KVH, D, **meta)
    v = torch.empty(B, T, KVH, D, **meta)
    s = (torch.zeros(B, T, dtype=torch.int32, device="meta") if seg
         else None)
    fwd = _Walk({})
    with _CostMode(fwd):
        out = dot_product_attention(q, k, v, causal=causal,
                                    segment_ids_q=s, segment_ids_kv=s,
                                    impl="dense")
    fwd.close()
    if not backward:
        return fwd.flops
    bwd = _Walk({})
    with _CostMode(bwd):
        torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    bwd.close()
    return bwd.flops


def _flash_scratch(name: str, args) -> tuple[int, int]:
    """Bytes the card's flash op holds beyond its outputs: (before its
    outputs exist, beside them). The backward computes δ = rowsum(dO∘O)
    from float32 copies of dO and O (three float32 (B·H, T, D) arrays at
    once), then holds δ (B·H, T) while the kernels write dQ, dK, dV."""
    if name != "flash_attention_bwd":
        return 0, 0
    q = args[1]
    wide = q.numel() * 4
    delta = q.shape[0] * q.shape[1] * 4
    return 3 * _rounded(wide) + _rounded(delta), _rounded(delta)


@dataclass
class _Walk:
    """Accumulators of one walk: flops, traffic, the live-bytes tallies
    of both columns (donation honoured, and ignored), and the flops
    inside every span the program opened (``regions``: name ->
    [(flops, flash calls)] per entry, resolved by ``estimate``)."""
    args: dict                 # storage key -> (bytes, donated)
    flops: float = 0.0
    traffic: float = 0.0
    live: int = 0              # donation honoured
    live_nd: int = 0           # donation ignored
    peak: int = 0
    peak_nd: int = 0
    unknown: dict = dataclasses.field(default_factory=dict)
    flash: dict = dataclasses.field(default_factory=dict)
    regions: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self._temps: dict = {}        # storage key -> bytes
        self._finalizers: list = []
        self._shadow: set = set()     # args written, donation honoured
        self._shadow_nd: set = set()  # args written, donation ignored
        self.thread = threading.get_ident()
        self.live = self.live_nd = sum(b for b, _ in self.args.values())
        self.peak, self.peak_nd = self.live, self.live_nd

    def watch_arg(self, key: int, storage) -> None:
        """A donated argument is freed (donation honoured) when its
        storage dies; the caller keeps every argument otherwise."""
        def free(b=self.args[key][0]):
            self.live -= b
        self._finalizers.append(weakref.finalize(storage, free))

    def see(self, t: torch.Tensor) -> None:
        """Count a storage not seen before from now until it dies."""
        key = _storage_key(t)
        if key in self._temps or key in self.args:
            return
        storage = t.untyped_storage()
        b = _rounded(storage.nbytes())
        self._temps[key] = b
        self.live += b
        self.live_nd += b

        def free(key=key, b=b):
            self._temps.pop(key, None)
            self.live -= b
            self.live_nd -= b
        self._finalizers.append(weakref.finalize(storage, free))

    def written(self, t: torch.Tensor) -> None:
        """An in-place write: to an argument the caller keeps, it is a
        fresh buffer of the argument's size (once per argument)."""
        key = _storage_key(t)
        if key not in self.args:
            return
        b, donated = self.args[key]
        if key not in self._shadow_nd:
            self._shadow_nd.add(key)
            self.live_nd += b
        if not donated and key not in self._shadow:
            self._shadow.add(key)
            self.live += b

    @contextlib.contextmanager
    def region(self, name: str):
        """A span the program opens (``profiling.annotate``): note the
        flops and flash calls at its two ends. Only the walk's own
        thread's spans: another thread's would take this walk's FLOPs
        for its own."""
        if threading.get_ident() != self.thread:
            yield
            return
        flops0, flash0 = self.flops, dict(self.flash)
        try:
            yield
        finally:
            flash = {k: n - flash0.get(k, 0) for k, n in self.flash.items()
                     if n > flash0.get(k, 0)}
            self.regions.setdefault(name, []).append(
                (self.flops - flops0, flash))

    def mark(self, before: int = 0, beside: int = 0,
             live_before: tuple = (0, 0)) -> None:
        self.peak = max(self.peak, self.live + beside,
                        live_before[0] + before)
        self.peak_nd = max(self.peak_nd, self.live_nd + beside,
                           live_before[1] + before)

    def close(self) -> None:
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()


def _tensors(args, kwargs) -> list:
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


class _CostMode(TorchDispatchMode):
    """Costs every aten op of the enclosed program into a ``_Walk``."""

    def __init__(self, walk: _Walk):
        super().__init__()
        self.walk = walk

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns, name, kind, writes = _op_info(func)
        if ns == "prim":
            # metadata queries: no tensor, no cost
            return func(*args, **kwargs)
        w = self.walk
        flat_in = _tensors(args, kwargs)
        for t in flat_in:
            w.see(t)
        for i, arg_name in writes:
            a = args[i] if i < len(args) else kwargs.get(arg_name)
            if isinstance(a, torch.Tensor):
                w.written(a)
        live_before = (w.live, w.live_nd)

        out = func(*args, **kwargs)

        if kind == "marker":
            # a record_function's enter or exit: no tensor work
            return out
        flat_out = ([out] if isinstance(out, torch.Tensor)
                    else _tensors(out, {}) if isinstance(out, (list, tuple))
                    else [])
        for t in flat_out:
            w.see(t)
        seen, traffic = set(), 0
        for t in flat_in:
            if id(t) not in seen:
                seen.add(id(t))
                traffic += _nbytes(t)
        w.traffic += traffic + sum(_nbytes(t) for t in flat_out)

        before = beside = 0
        if kind == "flash":
            key = _flash_key(name, args)
            w.flash[key] = w.flash.get(key, 0) + 1
            before, beside = _flash_scratch(name, args)
        elif kind == "matmul":
            w.flops += _matmul_flops(name, args)
        elif kind == "elementwise":
            w.flops += sum(t.numel() for t in flat_out)
        elif kind == "per_element":
            w.flops += _PER_ELEMENT[name] * sum(t.numel() for t in flat_out)
        elif kind == "reduction":
            w.flops += float(flat_in[0].numel()) if flat_in else 0.0
        elif kind == "unknown":
            label = f"{ns}.{func.overloadpacket.__name__}"
            w.unknown[label] = w.unknown.get(label, 0) + 1
        w.mark(before, beside, live_before)
        return out


@dataclass(frozen=True)
class CostEstimate:
    """What one call of the estimated function costs the card."""
    flops: float                    # executed flops (incl. remat recompute)
    hbm_traffic_bytes: float        # un-fused operand+result traffic
    peak_bytes: int                 # live-range peak, donation honoured
    peak_bytes_no_donation: int     # same walk, donation ignored
    arg_bytes: int                  # resident input footprint
    out_bytes: int                  # result footprint
    unknown_primitives: dict        # name -> count (bytes counted, 0 flops)
    while_loops: int                # always 0: eager loops walk every trip

    @property
    def donation_savings_bytes(self) -> int:
        return self.peak_bytes_no_donation - self.peak_bytes

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_traffic_bytes": self.hbm_traffic_bytes,
            "peak_bytes": self.peak_bytes,
            "peak_bytes_no_donation": self.peak_bytes_no_donation,
            "arg_bytes": self.arg_bytes,
            "out_bytes": self.out_bytes,
            "unknown_primitives": dict(self.unknown_primitives),
            "while_loops": self.while_loops,
        }


def _map(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map(fn, v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: _map(fn, getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    return x


def to_meta(t: torch.Tensor) -> torch.Tensor:
    """A meta tensor of ``t``'s shape, strides, dtype and
    ``requires_grad``: the walk's stand-in, which holds no memory."""
    if t.is_meta:
        return t
    m = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                            device="meta")
    return m.requires_grad_(t.requires_grad)


def _donated(fn, n_args: int, donate_argnums, donate_argnames) -> set:
    donate = set(donate_argnums or ())
    if donate_argnames:
        try:
            params = list(inspect.signature(fn).parameters)
            donate |= {params.index(n) for n in donate_argnames}
        except (ValueError, TypeError) as exc:
            raise ValueError(
                f"cannot resolve donate_argnames={donate_argnames!r} "
                f"against {fn!r}") from exc
    return {i for i in donate if i < n_args}


def _arg_storages(args, kwargs, donate: set) -> tuple[dict, dict]:
    """Per distinct argument storage: (rounded bytes, donated), and the
    storage objects of the donated ones. A storage shared by a kept
    argument is kept."""
    info, storages = {}, {}
    groups = [(tree_leaves(a), i in donate) for i, a in enumerate(args)]
    groups.append((tree_leaves(kwargs), False))
    for leaves, donated in groups:
        for t in leaves:
            key = _storage_key(t)
            if key not in info:
                storages[key] = t.untyped_storage()
                info[key] = (_rounded(storages[key].nbytes()), donated)
            elif not donated:
                info[key] = (info[key][0], False)
    return info, {k: storages[k] for k, (_, d) in info.items() if d}


def _resolve(flops: float, flash: dict) -> float:
    return flops + sum(n * _dense_attention_flops(key)
                       for key, n in flash.items())


def estimate(fn, *args, donate_argnums=(), donate_argnames=(),
             as_device: str | None = "cuda", regions: dict | None = None,
             **kwargs) -> CostEstimate:
    """Run ``fn(*args, **kwargs)`` on meta tensors and cost it.

    ``args`` and ``kwargs`` may be trees (dicts, lists, tuples,
    dataclasses such as a ``TrainState``) of meta tensors, used as they
    are (which keeps what the caller set up on them, such as
    ``requires_grad``), or of real ones, replaced by meta tensors of the
    same shapes (``to_meta``). Nothing is materialised.
    ``donate_argnums``/``donate_argnames`` name the arguments the caller
    gives up. ``as_device``: the device type the dispatch decisions take
    the tensors to be on ("cuda", the default: the card's path; None:
    their own). ``regions``, if given, receives the FLOPs of every
    span the program opened (``profiling.annotate``): ``{name: [flops
    of each entry]}``."""
    from kubeflow_rm_tpu_torch.ops.attention import as_device as _as

    args, kwargs = _map(to_meta, (args, kwargs))
    donate = _donated(fn, len(args), donate_argnums, donate_argnames)
    info, donated = _arg_storages(args, kwargs, donate)
    walk = _Walk(info)
    for key, storage in donated.items():
        walk.watch_arg(key, storage)
    del donated
    try:
        with _as(as_device), _CostMode(walk), observe(walk.region):
            out = fn(*args, **kwargs)
        walk.mark()
        out_bytes = sum({_storage_key(t): _rounded(t.untyped_storage()
                                                   .nbytes())
                         for t in tree_leaves(out)}.values())
    finally:
        walk.close()
    if regions is not None:
        for name, entries in walk.regions.items():
            regions[name] = [_resolve(f, fl) for f, fl in entries]
    return CostEstimate(
        flops=_resolve(walk.flops, walk.flash),
        hbm_traffic_bytes=walk.traffic,
        peak_bytes=walk.peak, peak_bytes_no_donation=walk.peak_nd,
        arg_bytes=sum(b for b, _ in info.values()), out_bytes=out_bytes,
        unknown_primitives=dict(walk.unknown), while_loops=0)


# ---------------------------------------------------------------------------
# self-check: the model's arithmetic on hand-computable programs
# ---------------------------------------------------------------------------

def selfcheck() -> list[str]:
    """Verify the cost model against hand-computable programs. Returns
    a list of failure strings (empty = pass)."""
    failures: list[str] = []

    def expect(label, got, want):
        if got != want:
            failures.append(f"{label}: got {got}, want {want}")

    a = torch.empty(64, 128, device="meta")
    b = torch.empty(128, 32, device="meta")
    x = torch.empty(1 << 20, device="meta")
    nbytes = (1 << 20) * 4

    # (64, 128) @ (128, 32): 2*M*N*K flops exactly
    est = estimate(torch.matmul, a, b)
    expect("matmul flops", est.flops, 2 * 64 * 32 * 128)
    expect("matmul unknown primitives", est.unknown_primitives, {})

    # donation: an in-place x.add_(1) given up by the caller peaks at one
    # buffer; kept by the caller it needs a second (the double-buffer
    # proof in miniature)
    don = estimate(lambda v: v.add_(1.0), x, donate_argnums=(0,))
    if not (nbytes <= don.peak_bytes < 2 * nbytes):
        failures.append(f"donated peak {don.peak_bytes} not in "
                        f"[{nbytes}, {2 * nbytes})")
    if don.peak_bytes_no_donation < 2 * nbytes:
        failures.append(f"non-donated peak {don.peak_bytes_no_donation}"
                        f" < {2 * nbytes}: double-buffer not modeled")

    # a Python loop is walked trip by trip: 10 trips of c * 2
    def looped(v):
        for _ in range(10):
            v = v * 2.0
        return v

    est = estimate(looped, x)
    expect("loop flops", est.flops, 10 * (1 << 20))
    return failures
