"""Sharding of the dense layer-potential applies over a mesh of devices.

The counterpart of ``ipde_tpu/parallel/sharded.py``.  A mesh here is an
ordered tuple of ``torch.device``s in one process, one per shard, as JAX's
``shard_map`` is one program over its devices; a device may repeat, so that
several shards can share one card.  The parallel axes are those of
``ipde_tpu``:
  (a) targets: each shard evaluates its slice of the targets against all
      sources, no communication (``sharded_*_apply``),
  (b) sources: each shard sums its slice of the sources at every target and
      the partial sums are added on the lead device
      (``source_sharded_laplace_slp_apply``),
  (c) the boundary axis of the lockstep annular GMRES
      (``solvers.annular_scalar.shard_boundary_axis``).

Every shard calls the one-device wrapper of its kernel
(``ops/kernels.py``, ``ops/stokes_kernels.py``): the CUDA kernel on a card,
the plain version on the CPU.  ``torch.tensor_split`` cuts the targets or
sources, so shards may be ragged or empty (an empty shard launches nothing)
and, unlike ``ipde_tpu``, nothing is padded to a multiple of the mesh size.
Results are gathered on ``mesh.lead`` in shard order, and partial sums are
added there in shard order: the same inputs give the same bits every run.

With a card as lead, each card shard's copy-in, kernel and copy-out run on
a stream of its own on its device (``run_shards``): the stream waits on an
event recorded on the caller's stream, and the caller's stream waits on one
recorded after the shard's work, before the gather or the sum.  That is the
fork and join that CUDA stream capture takes, so ``utils/planify.py``
captures the sharded applies into its graphs; eagerly, the shards of one
card overlap.  CPU shards run in place, on the host.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from ipde_tpu_torch.ops import kernels
from ipde_tpu_torch.ops import stokes_kernels as sk


def canonical_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index: a bare ``"cuda"``
    becomes the current card, so that equal devices compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An ordered tuple of devices, one per shard (a device may repeat).
    ``lead`` is the first: inputs come from it and results are gathered on
    it.  ``size`` is the number of shards, ``physical`` the number of
    distinct devices."""

    # attributes that cache tensors derived from plans (utils/planify.py
    # does not take them for plans)
    _plan_caches = ("boundary_groups",)

    def __init__(self, devices: Sequence):
        self.devices = tuple(canonical_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.lead = self.devices[0]
        self.size = len(self.devices)
        self.physical = len(set(self.devices))
        # the last split of a lockstep bundle over this mesh
        # (solvers.annular_scalar.shard_boundary_axis)
        self.boundary_groups = None

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int = None, devices: Sequence = None) -> Mesh:
    """A mesh of the first ``n_devices`` of ``devices`` (default all of
    them).  Without ``devices``, of the CUDA cards torch sees: it raises
    when there are fewer than ``n_devices`` (or none), and never stacks
    shards on fewer cards; to put several shards on one card, pass that
    card several times in ``devices``."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices) if n_devices is None else int(n_devices)
    if not 0 < n <= len(devices):
        raise RuntimeError(f"make_mesh: {n_devices} devices asked, "
                           f"{len(devices)} available")
    return Mesh(devices[:n])


def check_lead(mesh, device):
    """``mesh`` (None passes), after checking that its lead is ``device``:
    a solver's inputs live there and its results are gathered there."""
    if mesh is not None and mesh.lead != canonical_device(device):
        raise ValueError(f"the mesh's lead device {mesh.lead} is not the "
                         f"solver's device {device}")
    return mesh


def gather(parts, device):
    """The tensors ``parts`` concatenated on ``device`` in order; a single
    part is only moved there (on a one-shard mesh: returned as it is)."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts])


def _split(a, n: int):
    """``a`` cut into n shards as ``torch.tensor_split`` cuts it; one shard
    is ``a`` itself, so a one-shard mesh hands its caller's tensors on."""
    return (a,) if n == 1 else torch.tensor_split(a, n)


# (device, slot) -> the stream of the slot-th shard job of a fork on that
# card, made at first use and kept (a capture's warm-up makes them)
_streams = {}


def _shard_stream(device: torch.device, slot: int):
    """The stream that job ``slot`` of a fork runs on, on ``device``."""
    s = _streams.get((device, slot))
    if s is None:
        s = _streams[(device, slot)] = torch.cuda.Stream(device)
    return s


def run_shards(lead: torch.device, jobs):
    """``[fn() for dev, fn in jobs]``, each ``fn`` run for the shard device
    ``dev``.  With a card as ``lead``, each card job runs on a stream of its
    own (one per card and slot, kept) forked from the caller's stream on the
    lead, and the caller's stream joins every such stream before this
    returns: what the jobs return is then ready on the caller's stream, and
    a CUDA graph capture on the caller's stream takes the jobs' work.  CPU
    jobs, and every job of a CPU lead, run in place."""
    if lead.type != "cuda" or (len(jobs) == 1 and jobs[0][0] == lead):
        return [fn() for _, fn in jobs]
    caller = torch.cuda.current_stream(lead)
    outs, forked = [], []
    for slot, (dev, fn) in enumerate(jobs):
        if dev.type != "cuda":
            outs.append(fn())
            continue
        s = _shard_stream(dev, slot)
        s.wait_stream(caller)
        with torch.cuda.stream(s):
            outs.append(fn())
        forked.append(s)
    for s in forked:
        caller.wait_stream(s)
    return outs


def _target_sharded(mesh: Mesh, apply, sources, tx, ty):
    """apply(*sources, tx_shard, ty_shard) on each shard's device (a stream
    of its own on a card, ``run_shards``), the results (a tensor or a
    tuple) gathered on the lead in shard order."""
    lead = mesh.lead

    def job(dev, cx, cy):
        out = apply(*(s.to(dev) for s in sources), cx.to(dev), cy.to(dev))
        return tuple(o.to(lead) for o in
                     (out if isinstance(out, tuple) else (out,)))

    parts = run_shards(lead, [
        (dev, functools.partial(job, dev, cx, cy))
        for dev, cx, cy in zip(mesh.devices, _split(tx, mesh.size),
                               _split(ty, mesh.size)) if cx.shape[0] > 0])
    if not parts:       # no targets: the one-device call on the lead
        return apply(*sources, tx, ty)
    outs = tuple(gather([p[i] for p in parts], mesh.lead)
                 for i in range(len(parts[0])))
    return outs if len(outs) > 1 else outs[0]


def sharded_laplace_slp_apply(mesh: Mesh, sx, sy, weighted_charge, tx, ty):
    """Target-sharded Laplace single layer (``kernels.laplace_slp_apply``):
    each shard evaluates its slice of the targets against all sources."""
    return _target_sharded(mesh, kernels.laplace_slp_apply,
                           (sx, sy, weighted_charge), tx, ty)


def sharded_mh_slp_apply(mesh: Mesh, sx, sy, weighted_charge, tx, ty,
                         k: float):
    """Target-sharded Yukawa single layer (``kernels.mh_slp_apply``)."""
    return _target_sharded(
        mesh, lambda *a: kernels.mh_slp_apply(*a, k),
        (sx, sy, weighted_charge), tx, ty)


def sharded_stokes_slp_apply(mesh: Mesh, sx, sy, wfx, wfy, tx, ty):
    """Target-sharded Stokeslet apply -> (u, v, p)
    (``stokes_kernels.stokes_slp_apply``)."""
    return _target_sharded(mesh, sk.stokes_slp_apply, (sx, sy, wfx, wfy),
                           tx, ty)


def source_sharded_laplace_slp_apply(mesh: Mesh, sx, sy, weighted_charge,
                                     tx, ty):
    """Source-sharded Laplace single layer: each shard sums its slice of
    the sources at every target (a stream of its own on a card,
    ``run_shards``); the partial sums are added on the lead in shard order
    after the join (the counterpart of ``ipde_tpu``'s psum, without
    atomics)."""
    lead = mesh.lead

    def job(dev, csx, csy, cq):
        return kernels.laplace_slp_apply(csx.to(dev), csy.to(dev),
                                         cq.to(dev), tx.to(dev),
                                         ty.to(dev)).to(lead)

    parts = run_shards(lead, [
        (dev, functools.partial(job, dev, a, b, c))
        for dev, a, b, c in zip(mesh.devices, _split(sx, mesh.size),
                                _split(sy, mesh.size),
                                _split(weighted_charge, mesh.size))
        if a.shape[0] > 0])
    if not parts:       # no sources
        return kernels.laplace_slp_apply(sx, sy, weighted_charge, tx, ty)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total
