"""Data parallelism over several torch devices (↔ abismal_tpu/parallel/
mesh.py, the data axis of its mesh).

A mesh is a list of torch devices, one per slot.  A chunk's units split
into one contiguous slice per slot, and each slot runs the device program
on its slice with its own replica of the index tables, as JAX's shard_map
runs it per shard; the rows come back to the host in unit order, and the
statistics collective (JAX's psum) is a sum on the host.  Each slice sizes
its own candidate budget, extension pool and job table from the rows it
gets, so the rows equal JAX's mesh rows.

A mesh may name a device more than once: two slots on one card, or on the
CPU, run the same split as two cards do (the port's form of the JAX
tests' virtual CPU mesh), and slots on one device share its replica.  One
Python thread drives the slots in turn, so their launches serialize on
the host.

The key-range-sharded index (shard_stage1_tp, ↔ the JAX TP option) runs
over the same kind of mesh: there each slot holds one shard of the
position lists and gets the whole chunk."""

from __future__ import annotations

import contextlib

import torch

from ..device import put, require_cuda, resolve_device


def make_mesh(devices="all") -> list[torch.device]:
    """The mesh's slots: an int n or "all" names the first n (all) CUDA
    devices, and a count above torch.cuda.device_count() raises; a list
    names its slots' devices and may repeat one ("cpu", "cuda:0")."""
    if isinstance(devices, (list, tuple)):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        out = []
        for d in devices:
            dev = resolve_device(d)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            out.append(dev)
        return out
    require_cuda()
    count = torch.cuda.device_count()
    n = count if devices == "all" else int(devices)
    if not 1 <= n <= count:
        raise ValueError(f"a mesh of {n} CUDA devices on a machine with "
                         f"{count}")
    return [torch.device("cuda", i) for i in range(n)]


def replicate_tables(index, devices):
    """One DeviceIndex per mesh slot, uploaded once per distinct device
    (the tables are read-only)."""
    from ..map.pipeline import DeviceIndex

    made = {}
    for d in devices:
        if d not in made:
            made[d] = DeviceIndex.from_index(index, d)
    return [made[d] for d in devices]


def _on(dev):
    """Makes a CUDA slot's device current while its program is enqueued."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _run_slices(prog, devices, replicas, args, shared=()):
    """Runs prog on every slot with the host arrays args, in the
    program's order: those at the positions in shared whole, the others
    cut into len(devices) contiguous slices along their first axis.  All
    slots are enqueued before any result is copied back; returns the
    rows concatenated in slot order, on the CPU (for a program that
    returns a tuple, a tuple of them)."""
    n = len(devices)
    for i, a in enumerate(args):
        if i not in shared and a.shape[0] % n:
            raise ValueError(f"{a.shape[0]} rows do not split over a mesh "
                             f"of {n}")
    outs = []
    for s, (dev, rep) in enumerate(zip(devices, replicas)):
        sl = [a if i in shared else a[s * (a.shape[0] // n) :
                                      (s + 1) * (a.shape[0] // n)]
              for i, a in enumerate(args)]
        with _on(dev):
            outs.append(prog(*rep.tables(), *(put(a, dev) for a in sl)))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([o[k].cpu() for o in outs])
                     for k in range(len(outs[0])))
    return torch.cat([o.cpu() for o in outs])


def shard_stage1(stage1, devices):
    """The event-stream program (build_stage1) over the mesh (↔ JAX
    shard_stage1): wrapped(replicas, pnib, lens, is_ga, thr), host arrays
    split by unit.  Returns (ev, cf, total_events) on the CPU: each slot's
    (2, gcap) stream, slot s on rows (2s, 2s + 1); the count | overflow
    words of every unit in order; the accepted events summed over the
    slots on the host (JAX's psum)."""

    def wrapped(replicas, pnib, lens, is_ga, thr):
        ev, cf = _run_slices(stage1, devices, replicas,
                             (pnib, lens, is_ga, thr))
        return ev, cf, int((cf & 0x3FFFFFFF).sum())

    return wrapped


def shard_stage1_tp(stage1, devices):
    """The event-stream program over a key-range-sharded index (↔ JAX
    shard_stage1_tp; stage1 built with tp=True): wrapped(slots, pnib,
    lens, is_ga, thr), slots the DeviceIndexTP's per-slot tensors.  Every
    slot probes the buckets it owns for the WHOLE unit batch (uploaded
    once per distinct device); all slots are enqueued before any result
    is copied back.  Returns (ev, cf) on the CPU: slot s's (2, gcap)
    stream on rows (2s, 2s + 1), and cf (n_slots, B), every slot's count
    | overflow words of every unit (map.host_units._merge_tp_streams
    merges them)."""

    def wrapped(slots, pnib, lens, is_ga, thr):
        units, outs = {}, []
        for dev, (g32, c2, c3, index_local, shard) in zip(devices, slots):
            if dev not in units:
                units[dev] = [put(a, dev) for a in (pnib, lens, is_ga, thr)]
            with _on(dev):
                outs.append(stage1(g32, c2, c3, index_local, *units[dev],
                                   shard=shard))
        return (torch.cat([ev.cpu() for ev, _ in outs]),
                torch.stack([cf.cpu() for _, cf in outs]))

    return wrapped


def shard_stage12(stage12, devices):
    """The fused SE program (build_stage12) over the mesh (↔ JAX
    shard_stage12): wrapped(replicas, pnib, lens, is_ga, scode,
    max_diffs_r), host arrays; pnib, lens and is_ga split by unit,
    max_diffs_r by read, scode is replicated.  Returns (rows, counts):
    the packed rows of every read in order and the decision counts
    [unmapped, exact, aligned, fallback] of rec[:, 0] & 7, summed over
    the slots on the host; both on the CPU."""

    def wrapped(replicas, pnib, lens, is_ga, scode, max_diffs_r):
        rows = _run_slices(stage12, devices, replicas,
                           (pnib, lens, is_ga, scode, max_diffs_r), (3,))
        counts = torch.bincount((rows[:, 0] & 7).long(), minlength=4)[:4]
        return rows, counts

    return wrapped


def shard_stage12pe(stage12pe, devices):
    """The fused PE program (build_stage12pe) over the mesh (↔ JAX
    shard_stage12pe): wrapped(replicas, pnib, lens, is_ga, max_diffs_u,
    pe_dist), host arrays split by unit, pe_dist replicated.  Returns
    (rows, n_fallback): the packed rows of every unit in order, on the
    CPU, and the count of units handed back to the host (cnt < 0)."""

    def wrapped(replicas, pnib, lens, is_ga, max_diffs_u, pe_dist):
        rows = _run_slices(stage12pe, devices, replicas,
                           (pnib, lens, is_ga, max_diffs_u, pe_dist), (4,))
        # packed row layout: [pos(K) | ds(K) | cnt | mate(5)]
        cnt = rows[:, (rows.shape[1] - 6) // 2 * 2]
        return rows, int((cnt < 0).sum())

    return wrapped
