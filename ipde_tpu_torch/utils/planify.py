"""Planify: run a whole solve as a replay of captured CUDA graphs, with the
solver's plan tensors in buffers that a rebuilt solver can be copied into.

The counterpart of ``ipde_tpu/utils/planify.py``, which jits a solve with
every plan array (DFT matrices, QFS maps, preconditioner blocks, masks, ...)
passed in as an argument, so that one compiled program serves every solver
of the same shapes.  Here:

  * ``PlanStore`` walks an object graph (``ipde_tpu_torch`` objects and the
    list, tuple and dict containers hanging off them), collects every
    ``torch.Tensor`` leaf (deduped by id) and can swap other tensors into
    the exact slots they came from;
  * ``planified(fn, *roots)`` returns ``call``.  With the plans on a card,
    the first call runs ``fn`` once eagerly on a side stream (cuFFT plans,
    cuBLAS handles, device tables, kernel libraries and split scratch are
    made there), then captures ``fn`` into CUDA graphs that share one
    memory pool, with the plans swapped for copies of them (``call.plans``)
    and the arguments for static buffers.  Each GMRES loop of ``fn``
    (``ops/gmres.py``) closes the current graph, captures its own three
    phases and registers its host loop; the next graph starts after it.
    Every call copies its arguments into the static buffers, replays the
    graphs and loops in order and returns clones of the outputs.  With the
    plans on the CPU, ``call`` runs ``fn`` with the plans installed, as
    ipde_tpu's ``jit=False`` does;
  * under ``use_mesh`` (a root holding a ``parallel.sharded.Mesh`` of
    several shards) the capture takes the sharded applies and the split
    lockstep GMRES too: each card shard's work runs on a stream of its own,
    forked from the capturing stream and joined back into it
    (``parallel.sharded.run_shards``), so it lands in the same graphs; the
    graphs' memory is one pool per card of the mesh.  Every plan must lie
    on a device of the mesh, and a mesh with CPU shards beside a card
    raises (a CUDA graph cannot hold CPU work); a mesh of CPU shards runs
    ``fn`` with the plans installed, as above;
  * ``replan(call, *roots)`` points ``call`` at a rebuilt object graph of
    the same structure: it checks every plan tensor's shape, dtype and
    device and copies the new values into ``call.plans``, so the captured
    graphs run on the new solver without a capture.

    run = planified(lambda fg, fr: bie.apply_bc(solver(EF(fg, [fr])), bc)
                    .grid, solver, bie)
    u = run(f.grid, f.radials[0])     # captured once; replays after
    replan(run, solver2, bie2)        # same shapes: no capture

What ``fn`` computes on the host (Python numbers, numpy arrays) is fixed at
capture, as it is by ipde_tpu's trace; only tensors reachable from the
roots are plans.  A capture that fails raises: there is no eager fallback
on a card.
"""

from __future__ import annotations

import contextlib
import importlib
import threading
import time
import weakref
from typing import Any, Callable, List, Sequence, Tuple

import torch

from ipde_tpu_torch.utils.profiling import count, span, spanned

# the kernel wrappers whose ``launches`` count a replay adds to: (module,
# module-level name), read through the module so that a monkeypatched
# wrapper carrying the attribute is counted
_COUNTED = (("ipde_tpu_torch.ops.kernels", "laplace_slp_apply"),
            ("ipde_tpu_torch.ops.kernels", "laplace_slp_grad_apply"),
            ("ipde_tpu_torch.ops.kernels", "mh_slp_apply"),
            ("ipde_tpu_torch.ops.stokes_kernels", "stokes_slp_apply"))

_active = threading.local()

# launches recorded in captures (not run then) and launches run by replays,
# per wrapper of _COUNTED since the process started: a tool that records a
# wrapper's calls reconciles them with its ``launches`` count by these
_book = {"captured": [0] * len(_COUNTED), "replayed": [0] * len(_COUNTED)}


def _is_ours(obj) -> bool:
    mod = type(obj).__module__
    return mod is not None and mod.split(".")[0] == "ipde_tpu_torch"


def _flatten(value) -> Tuple[list, Any]:
    """(leaves, treedef) of nested lists, tuples (namedtuples kept) and
    dicts; anything else is a leaf."""
    if isinstance(value, dict):
        keys = list(value.keys())
        parts = [_flatten(value[k]) for k in keys]
        return ([leaf for p in parts for leaf in p[0]],
                ("dict", keys, [p[1] for p in parts], [len(p[0])
                                                        for p in parts]))
    if isinstance(value, (list, tuple)):
        parts = [_flatten(v) for v in value]
        return ([leaf for p in parts for leaf in p[0]],
                (type(value), None, [p[1] for p in parts],
                 [len(p[0]) for p in parts]))
    return [value], None


def _unflatten(treedef, leaves):
    if treedef is None:
        return leaves[0]
    kind, keys, subs, sizes = treedef
    items, i = [], 0
    for sub, n in zip(subs, sizes):
        items.append(_unflatten(sub, leaves[i:i + n]))
        i += n
    if kind == "dict":
        return dict(zip(keys, items))
    if kind is list:
        return items
    if hasattr(kind, "_fields"):            # namedtuple
        return kind(*items)
    return kind(items)


class PlanStore:
    """Collects and swaps the tensor leaves of an object graph."""

    def __init__(self, *roots):
        # each slot: (container, key, treedef, spec), spec a list of
        # ('arr', plan index) or ('static', value)
        self._slots: List[Tuple[Any, Any, Any, list]] = []
        self._slot_names: List[str] = []
        self._arrays: List[torch.Tensor] = []
        self._by_id = {}
        self.meshes = []       # (owner path, devices) of multi-shard meshes
        seen = set()
        for r in roots:
            self._walk(r, seen, type(r).__name__)

    # -- construction ------------------------------------------------------
    def _walk(self, obj, seen, name):
        if id(obj) in seen:
            return
        seen.add(id(obj))
        if isinstance(obj, dict):
            container, keys = obj, list(obj.keys())
        elif isinstance(obj, list):
            container, keys = obj, range(len(obj))
        elif _is_ours(obj) and hasattr(obj, "__dict__"):
            skip = getattr(type(obj), "_plan_caches", ())
            container = obj.__dict__
            keys = [k for k in container if k not in skip]
            if type(obj).__name__ == "Mesh" and getattr(obj, "size", 1) > 1:
                self.meshes.append((name, obj.devices))
            name = type(obj).__name__
        elif isinstance(obj, tuple):
            for item in obj:
                self._walk(item, seen, name)
            return
        else:
            return
        for k in keys:
            self._process_slot(container, k, container[k], seen, name)

    def _plan_index(self, arr) -> int:
        idx = self._by_id.get(id(arr))
        if idx is None:
            idx = len(self._arrays)
            self._arrays.append(arr)
            self._by_id[id(arr)] = idx
        return idx

    def _process_slot(self, container, key, value, seen, name):
        leaves, treedef = _flatten(value)
        spec = []
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                spec.append(("arr", self._plan_index(leaf)))
            else:
                spec.append(("static", leaf))
        if any(s[0] == "arr" for s in spec):
            self._slots.append((container, key, treedef, spec))
            self._slot_names.append(f"{name}.{key}")
        for leaf in leaves:
            if not isinstance(leaf, torch.Tensor):
                self._walk(leaf, seen, f"{name}.{key}")

    # -- use -----------------------------------------------------------------
    @property
    def n_arrays(self) -> int:
        return len(self._arrays)

    def slot_owner(self, plan_index: int) -> str:
        """Owner path of a plan-tensor index (replan's diagnostics)."""
        for (_c, _k, _td, spec), nm in zip(self._slots, self._slot_names):
            if any(s[0] == "arr" and s[1] == plan_index for s in spec):
                return nm
        return "<unknown>"

    def name_occurrences(self):
        """{owner path: [plan indices in walk order]}; a tensor shared by
        several slots appears under each owner's name."""
        groups = {}
        for (_c, _k, _td, spec), nm in zip(self._slots, self._slot_names):
            for s in spec:
                if s[0] == "arr":
                    groups.setdefault(nm, []).append(s[1])
        return groups

    def snapshot(self) -> list:
        """The current plan tensors."""
        return list(self._arrays)

    def refresh(self):
        """Re-read the plan tensors from the object graph (after a host
        update of some plan attribute)."""
        for container, key, _treedef, spec in self._slots:
            leaves, _ = _flatten(container[key])
            for leaf, s in zip(leaves, spec):
                if s[0] == "arr":
                    self._arrays[s[1]] = leaf

    @contextlib.contextmanager
    def installed(self, arrays: Sequence):
        """Temporarily replace every captured tensor slot with ``arrays``."""
        originals = []
        try:
            for container, key, treedef, spec in self._slots:
                originals.append((container, key, container[key]))
                leaves = [arrays[s[1]] if s[0] == "arr" else s[1]
                          for s in spec]
                container[key] = _unflatten(treedef, leaves)
            yield
        finally:
            for container, key, orig in originals:
                container[key] = orig


# -- capture ---------------------------------------------------------------

def recording():
    """The recorder of the capture running on this thread, else None (what
    a GMRES loop asks before it runs eagerly)."""
    return getattr(_active, "recorder", None)


def _launch_counts() -> List[int]:
    return [getattr(importlib.import_module(m), n).launches
            for m, n in _COUNTED]


def _add_launches(counts, book: str = None):
    for i, ((m, n), c) in enumerate(zip(_COUNTED, counts)):
        if c:
            getattr(importlib.import_module(m), n).launches += c
            if book:
                _book[book][i] += c


def launch_book() -> dict:
    """{wrapper name: (launches recorded in captures, launches run by
    replays)} since the process started."""
    return {n: (c, r) for (_, n), c, r in zip(_COUNTED, _book["captured"],
                                               _book["replayed"])}


class _Recorder:
    """The graphs and loops of one capture, in order.  ``steps`` holds
    ("graph", graph, launches) and ("loop", gmres loop, [(graph, launches)
    for its start, chunk and end])."""

    def __init__(self, pool):
        self.pool = pool
        self.steps = []
        self._open = None

    def begin(self):
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self._open = (g, _launch_counts())

    def _end(self):
        g, before = self._open
        self._open = None
        g.capture_end()
        counts = [a - b for a, b in zip(_launch_counts(), before)]
        for i, c in enumerate(counts):
            _book["captured"][i] += c
        return g, counts

    def end(self):
        self.steps.append(("graph",) + self._end())

    def add_loop(self, loop):
        """Close the current graph, capture the loop's three phases, open
        the next graph."""
        self.end()
        phases = []
        for phase in (loop.start, loop.chunk, loop.end):
            self.begin()
            phase()
            phases.append(self._end())
        self.steps.append(("loop", loop, phases))
        self.begin()

    def abort(self):
        """End a capture left open by an exception (its graph is
        dropped)."""
        if self._open is not None:
            g = self._open[0]
            self._open = None
            with contextlib.suppress(Exception):
                g.capture_end()

    def replay(self):
        for step in self.steps:
            if step[0] == "graph":
                step[1].replay()
                _add_launches(step[2], "replayed")
                count("planify.graphs")
                continue
            loop, phases = step[1], step[2]

            def run(i, phases=phases):
                phases[i][0].replay()
                _add_launches(phases[i][1], "replayed")
                count("planify.graphs")
            loop.drive(lambda: run(0), lambda: run(1), lambda: run(2))

    @property
    def n_graphs(self) -> int:
        return sum(1 if s[0] == "graph" else 3 for s in self.steps)


def _tensors(tree) -> list:
    return [leaf for leaf in _flatten(tree)[0]
            if isinstance(leaf, torch.Tensor)]


def _map_tensors(fn, tree):
    leaves, treedef = _flatten(tree)
    return _unflatten(treedef, [fn(x) if isinstance(x, torch.Tensor) else x
                                for x in leaves])


@contextlib.contextmanager
def _pools_on(cards, pool):
    """While a capture runs on another card: this thread's allocations on
    ``cards`` (the mesh's other cards) go to the capture's pool there, so
    that the graphs keep that memory."""
    for d in cards:
        torch._C._cuda_beginAllocateCurrentThreadToPool(d.index, pool)
    try:
        yield
    finally:
        for d in cards:
            torch._C._cuda_endAllocateToPool(d.index, pool)


def _release_pools(indices, pool):
    for i in indices:
        torch._C._cuda_releasePool(i, pool)


class _Captured:
    """The CUDA side of a planified call: static buffers, the recorder and
    what the capture measured.  ``cards`` are the cards the capture spans
    (the plans' card first)."""

    @spanned("planify.capture")
    def __init__(self, fn, store, roots, plans, args, cards):
        dev = cards[0]
        others = cards[1:]
        with torch.no_grad():
            self.plans = [p.clone() for p in plans]
            self.static_args = _map_tensors(lambda t: t.clone(), args)
        self._arg_spec = _flatten(args)[1]
        self.plan_bytes = sum(_nbytes(p) for p in self.plans)
        caller = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(caller)
        t0 = time.perf_counter()
        with torch.cuda.device(dev), torch.cuda.stream(side):
            with span("planify.warmup"), store.installed(self.plans):
                fn(*self.static_args)        # the eager warm-up
            _check_no_growth(store, roots)
            reserved = [torch.cuda.memory_reserved(d) for d in cards]
            pool = torch.cuda.graph_pool_handle()
            rec = _Recorder(pool)
            counts = _launch_counts()
            _active.recorder = rec
            try:
                with span("planify.record"), _pools_on(others, pool), \
                        store.installed(self.plans):
                    rec.begin()
                    out = fn(*self.static_args)
                    rec.end()
            except BaseException:
                rec.abort()
                raise
            finally:
                _active.recorder = None
                # nothing ran during the capture
                _add_launches([a - b for a, b in zip(counts,
                                                     _launch_counts())])
        caller.wait_stream(side)
        self.capture_s = time.perf_counter() - t0
        # the graphs' pool on each card, and in all
        self.pool_bytes_by_card = {
            str(d): torch.cuda.memory_reserved(d) - r
            for d, r in zip(cards, reserved)}
        self.pool_bytes = sum(self.pool_bytes_by_card.values())
        if others:
            weakref.finalize(self, _release_pools,
                             [d.index for d in others], pool)
        self.recorder = rec
        self.out = out

    @spanned("planify.replay")
    def __call__(self, args):
        if _flatten(args)[1] != self._arg_spec:
            raise ValueError("planified: the arguments' structure differs "
                             "from the captured call's")
        with torch.no_grad():
            for dst, src in zip(_tensors(self.static_args), _tensors(args)):
                if dst.shape != src.shape or dst.dtype != src.dtype:
                    raise ValueError(
                        f"planified: argument {tuple(src.shape)}/{src.dtype}"
                        f" vs captured {tuple(dst.shape)}/{dst.dtype}")
                dst.copy_(src)
        self.recorder.replay()
        return _map_tensors(lambda t: t.clone(), self.out)


def planified(fn: Callable, *roots, capture: bool = True):
    """Wrap ``fn`` so that every tensor reachable from ``roots`` is a plan
    that ``replan`` can replace.  Returns ``call``, with the signature of
    ``fn``; ``call.store``, ``call.plans`` and ``call.inner`` (``inner(plans,
    *args)``: ``fn`` with ``plans`` installed) as in ipde_tpu.

    With the plans on a card and ``capture`` (the default), the first call
    captures ``fn`` (see the module docstring) and every call replays it;
    ``call.captured`` then holds the static buffers, the recorder and the
    capture's seconds and pool bytes.  Otherwise (plans on the CPU, or
    ``capture=False``, ipde_tpu's ``jit=False``) a call runs ``inner``.
    A root may hold a mesh of several shards (``use_mesh``): the capture
    then spans the mesh's cards.  Raises ValueError (here, and at the first
    call after a ``replan``) when the plans lie on several devices without
    a mesh or off the mesh, and, with ``capture``, when a mesh puts CPU
    shards beside a card."""
    store = PlanStore(*roots)

    def inner(plan_arrays, *args):
        with store.installed(plan_arrays):
            return fn(*args)

    def call(*args):
        first = call.calls == 0
        call.calls += 1
        cards = [] if call.captured is not None else _capture_cards(
            call.plans, store.meshes, capture)
        if cards:
            # fn's objects are the roots': their slots take the copies
            call.captured = _Captured(fn, store, roots, call.plans, args,
                                      cards)
            call.plans = call.captured.plans
        if call.captured is not None:
            return call.captured(args)
        out = inner(call.plans, *args)
        if first:
            _check_no_growth(store, roots)
        return out

    call.store = store
    call.plans = store.snapshot()
    call.inner = inner
    call.captured = None
    call.calls = 0
    _capture_cards(call.plans, store.meshes, capture)
    return call


def capacity(used: int, cap: int) -> int:
    """The size of a plan tensor of a padded (``pad_quantum``) registration:
    ``cap``, a bound that a turned boundary keeps, so that ``replan`` holds;
    ``used`` where it exceeds ``cap``, counted as ``plan.capacity_overflow``
    (that rebuild's ``replan`` then misses and captures again)."""
    if used > cap:
        count("plan.capacity_overflow")
        return used
    return cap


def _check_no_growth(store, roots):
    """Raise when a call left plan tensors on the roots that ``store`` does
    not hold (made lazily at first use): a replay would keep the first
    objects' values there, and ``replan`` could not reach them."""
    grown = PlanStore(*roots)
    if grown.n_arrays != store.n_arrays:
        new = [grown.slot_owner(i)
               for i in range(store.n_arrays, grown.n_arrays)]
        raise RuntimeError(
            "planified: the first call made plan tensors that the store "
            f"does not hold ({', '.join(new[:8])}): build them when their "
            "object is made")


def _capture_cards(plans, meshes, capture: bool) -> list:
    """The cards a capture of ``plans`` spans, the plans' card first (the
    cards of the roots' meshes; ``meshes`` as ``PlanStore.meshes``), or []
    when a call runs ``inner`` (plans and shards on the CPU, or no
    ``capture``).  Raises ValueError when the plans lie on several devices
    without a mesh or off the mesh, or when a mesh puts CPU shards beside a
    card."""
    if not capture:
        return []
    devs = {p.device for p in plans}
    shards = [(n, i, d) for n, ds in meshes for i, d in enumerate(ds)]
    on_mesh = {d for _, _, d in shards}
    cards = sorted({d for d in devs | on_mesh if d.type == "cuda"},
                   key=lambda d: (d not in devs, d.index))
    if not cards:
        return []
    cpu = [f"{n} shard {i}" for n, i, d in shards if d.type != "cuda"]
    if cpu:
        raise ValueError(
            f"planified: {', '.join(cpu)} on the CPU beside "
            f"{[str(d) for d in cards]}: a CUDA graph cannot hold CPU work")
    if meshes and not devs <= on_mesh:
        raise ValueError(f"planified: plans on {sorted(map(str, devs))}, "
                         f"not all of them devices of the mesh "
                         f"{sorted(map(str, on_mesh))}")
    if len(devs) > 1 and not meshes:
        raise ValueError(f"planified: plans on several devices {devs}")
    return cards


def _nbytes(t: torch.Tensor) -> int:
    """The bytes a tensor holds (a sparse CSR one: its three arrays)."""
    if t.layout == torch.sparse_csr:
        return sum(_nbytes(a) for a in (t.crow_indices(), t.col_indices(),
                                        t.values()))
    return t.numel() * t.element_size()


def _spec(t: torch.Tensor) -> str:
    """What a captured buffer fixes of a plan tensor: shape, dtype, device,
    and for a sparse one its layout and number of entries."""
    out = f"{tuple(t.shape)}/{t.dtype}/{t.device}"
    if t.layout != torch.strided:
        out += f"/{t.layout}/nnz {t._nnz()}"
    return out


@spanned("planify.replan")
def replan(call, *roots):
    """Point a planified callable at a new object graph of the same
    structure, e.g. this step's solver rebuilt on moved geometry.

    Builds the new graph's store and checks its plan tensors against
    ``call.plans`` (count, shape, dtype, device; ValueError on a
    mismatch).  Before the first capture, ``call.plans`` becomes the new
    tensors; after it, their values are copied into the captured plan
    buffers, which the graphs read, and no capture is made."""
    store = PlanStore(*roots)
    new = store.snapshot()
    old = call.plans
    if len(new) != len(old):
        raise ValueError(
            f"replan: new graph has {len(new)} plan arrays, compiled "
            f"program expects {len(old)} (structure changed?)")
    bad = [f"slot {i} ({store.slot_owner(i)}): {_spec(a)} vs compiled "
           f"{_spec(b)}" for i, (a, b) in enumerate(zip(new, old))
           if _spec(a) != _spec(b)]
    if bad:
        raise ValueError("replan: plan shape mismatch — " + "; ".join(bad))
    if [d for _, d in store.meshes] != [d for _, d in call.store.meshes]:
        raise ValueError(
            f"replan: the new graph's meshes {store.meshes} are not the "
            f"planified call's {call.store.meshes}")
    if call.captured is not None:
        with torch.no_grad():
            for dst, src in zip(call.captured.plans, new):
                dst.copy_(src)
        call.store = store
        return call
    call.store = store
    call.plans = new
    return call
