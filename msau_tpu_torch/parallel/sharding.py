"""Process groups, device meshes and batch shards over ``torch.distributed``.

Port of ``msau_tpu.parallel.sharding``.  The JAX package builds a
``jax.sharding.Mesh`` over the devices of one program and lets GSPMD
partition the step; the port runs one process per device (rank r on
``cuda:r``, or on the CPU with gloo) and says by hand which slice each
rank holds:

  * ``make_mesh`` names the dims of the ranks' grid (``("data",)``,
    ``("data", "spatial")``) as a ``DeviceMesh``;
  * ``batch_sharding``, ``spatial_sharding`` and ``replicated`` describe a
    slice as ``PartitionSpec`` does, one mesh axis name (or None) per
    tensor dim, and ``Sharding.local`` takes it;
  * ``shard_batch`` gives a rank its slice of a global batch that every
    rank holds in full: its block of dim 0 on the ``data`` axis and, with
    a ``spatial`` axis, its block of H rows (dim 1 of NHWC inputs and
    [N, H, W] labels);
  * ``maybe_initialize_distributed`` sets up the process group from its
    arguments or torchrun's variables, ``spawn_workers`` starts local
    ranks itself, and ``host_local_batch_to_global`` checks a batch that
    each rank was fed on its own.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def make_mesh(shape: Sequence[int] = (-1,), axes: Sequence[str] = ("data",),
              device_type: str = "cuda"):
    """A ``DeviceMesh`` over the process group's first prod(shape) ranks,
    row-major, with dims named ``axes``; one -1 takes the rest of the
    world size.  ValueError where the mesh needs more ranks than there
    are."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (see "
                           "maybe_initialize_distributed)")
    shape, axes = list(shape), tuple(axes)
    if len(shape) != len(axes) or shape.count(-1) > 1:
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    n = dist.get_world_size()
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        shape[shape.index(-1)] = n // known
    total = int(np.prod(shape))
    if not 0 < total <= n:
        raise ValueError(f"mesh {shape} needs {total} ranks, have {n}")
    return DeviceMesh(device_type, torch.arange(total).reshape(shape),
                      mesh_dim_names=axes)


def axis_size(mesh, axis: str) -> int:
    """The mesh's size along ``axis``, 1 where it has no such axis."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``, or None where
    the mesh has no such axis or it has one rank."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which slice of a tensor a rank holds: ``spec[d]`` names the mesh
    axis that splits dim d into equal blocks (block i to the ranks at
    coordinate i), None keeps dim d whole: ``PartitionSpec``'s meaning."""

    mesh: Any
    spec: Tuple[Optional[str], ...] = ()

    def local(self, x):
        """This rank's block of ``x`` (numpy or torch), a view."""
        coord = self.mesh.get_coordinate()
        names = self.mesh.mesh_dim_names or ()
        for d, axis in enumerate(self.spec):
            if axis is None:
                continue
            if axis not in names:
                raise ValueError(f"no mesh axis {axis!r} in {names}")
            i = names.index(axis)
            size = self.mesh.size(i)
            if x.shape[d] % size:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                                 f"into {size} blocks over {axis!r}")
            step = x.shape[d] // size
            x = x[(slice(None),) * d
                  + (slice(coord[i] * step, (coord[i] + 1) * step),)]
        return x


def batch_sharding(mesh, ndim: int, batch_axis: str = "data") -> Sharding:
    """Dim 0 split over ``batch_axis``, the rest whole."""
    return Sharding(mesh, (batch_axis,) + (None,) * (ndim - 1))


def spatial_sharding(mesh, ndim: int, batch_axis: str = "data",
                     spatial_axis: str = "spatial", h_dim: int = 1) -> Sharding:
    """Dim 0 split over ``batch_axis`` and dim ``h_dim`` (H) over
    ``spatial_axis``."""
    spec = [None] * ndim
    spec[0] = batch_axis
    spec[h_dim] = spatial_axis
    return Sharding(mesh, tuple(spec))


def replicated(mesh) -> Sharding:
    return Sharding(mesh)


def mesh_device(mesh) -> torch.device:
    """This rank's device of the mesh's type (the current CUDA device)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(batch: Dict[str, Any], mesh, batch_axis: str = "data",
                device=None) -> Dict[str, torch.Tensor]:
    """This rank's slice of a global batch (a dict of numpy arrays or
    tensors, every rank holding the same) as tensors on ``device``
    (default: the mesh's device): its block of dim 0 over ``batch_axis``
    and, where the mesh has a ``spatial`` axis, its block of dim 1 (H)."""
    device = mesh_device(mesh) if device is None else torch.device(device)
    spatial = "spatial" in (mesh.mesh_dim_names or ())
    out = {}
    for k, v in batch.items():
        nd = np.ndim(v)
        sharding = (spatial_sharding(mesh, nd, batch_axis) if spatial
                    else batch_sharding(mesh, nd, batch_axis))
        part = sharding.local(v)
        out[k] = torch.as_tensor(np.ascontiguousarray(part) if
                                 isinstance(part, np.ndarray) else part
                                 ).to(device)
    return out


def sum_over_ranks(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (default: all), in place;
    every rank gets the same bits."""
    dist.all_reduce(t, group=group)
    return t


FLAT_ALIGN = 64   # bytes: each tensor's piece of a flat buffer starts on
                  # a multiple of this


def sum_flat(tensors: Sequence[torch.Tensor], group=None):
    """The tensors summed over the ranks in one flat buffer (their widest
    float dtype, at least f32), in their given order -> new tensors of
    their shapes and dtypes.  Each piece starts on a multiple of FLAT_ALIGN
    bytes, so the returned views take the same kernels' paths as tensors
    of their own: ``_foreach_norm``, say, sums an unaligned tensor in
    another order, and a one-rank mesh's step would then differ in the
    last bit from the mesh-less step."""
    dt = torch.float32
    for t in tensors:
        dt = torch.promote_types(dt, t.dtype)
    step = FLAT_ALIGN // torch.empty((), dtype=dt).element_size()
    pad = torch.zeros(step, dtype=dt, device=tensors[0].device)
    parts, offsets, i = [], [], 0
    for t in tensors:
        parts.append(t.reshape(-1).to(dt))
        offsets.append(i)
        extra = -t.numel() % step
        if extra:
            parts.append(pad[:extra])
        i += t.numel() + extra
    flat = torch.cat(parts)
    sum_over_ranks(flat, group)
    return [flat[i:i + t.numel()].view(t.shape).to(t.dtype)
            for i, t in zip(offsets, tensors)]


def broadcast_flat(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Copy rank ``src``'s values of the tensors into every rank's, in
    place, through one flat buffer."""
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.broadcast(flat, src)
        i = 0
        for t in tensors:
            t.copy_(flat[i:i + t.numel()].view(t.shape))
            i += t.numel()


# ---------------------------------------------------------------------------
# process groups: torchrun's variables, explicit coordinates, local workers
# ---------------------------------------------------------------------------
def maybe_initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Initialise the default process group when given coordinates: the
    arguments (``host:port``, or a ``tcp://`` / ``file://`` URL), or
    torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
    ``WORLD_SIZE``.  ``backend`` defaults to NCCL where CUDA is available
    and gloo otherwise.  Returns True once a group exists; False, doing
    nothing, when it gets neither (a single-process run)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "WORLD_SIZE" not in env:
            return False
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    return True


def _worker(fn, rank, world, init, backend, args):
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_workers(fn: Callable, nprocs: int, *args, backend: str = "gloo",
                  timeout: Optional[float] = None) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` new local processes (the
    ``spawn`` start method), each in a process group of ``backend`` set up
    from a file store in a fresh temporary directory, so concurrent runs
    never race for a port.  Raises RuntimeError, after stopping the rest,
    when a worker fails or ``timeout`` seconds pass."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    root = tempfile.mkdtemp(prefix="msau_dist_")
    init = "file://" + os.path.join(root, "store")
    procs = [ctx.Process(target=_worker,
                         args=(fn, r, nprocs, init, backend, args))
             for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
            if p.exitcode is None or p.exitcode != 0:
                what = ("timed out" if p.exitcode is None
                        else f"exited with {p.exitcode}")
                raise RuntimeError(f"worker {procs.index(p)} of {nprocs} "
                                   f"{what}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
        shutil.rmtree(root, ignore_errors=True)


def host_local_batch_to_global(batch: Dict[str, Any], mesh,
                               batch_axis: str = "data",
                               device=None) -> Dict[str, torch.Tensor]:
    """A batch that each rank was fed on its own (its block of the global
    batch), as tensors on ``device``: the rank keeps its slice as it is,
    and the shapes must agree across the ranks (ValueError otherwise), as
    ``jax.make_array_from_process_local_data`` assembles equal blocks."""
    device = mesh_device(mesh) if device is None else torch.device(device)
    shapes = {k: tuple(np.shape(v)) for k, v in sorted(batch.items())}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, shapes)
    if any(s != shapes for s in every):
        raise ValueError(f"host-local batches differ across ranks: {every}")
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _on_device(rank, fn, cuda, args):
    if cuda:
        torch.cuda.set_device(rank)
    fn(*args)


def run_on_devices(fn: Callable, devices: int, device, *args):
    """Run ``fn(*args)`` once on each of ``devices`` ranks: in this process
    when ``devices`` is 1; under torchrun, in the group it set up (NCCL on
    ``cuda:LOCAL_RANK``, gloo on the CPU); else in ``devices`` local
    workers (``spawn_workers``), rank r on ``cuda:r`` with NCCL, or on the
    CPU with gloo when ``device`` is the CPU.  ValueError where
    ``devices`` is more than the CUDA devices there are."""
    cuda = torch.device(device).type == "cuda"
    if devices < 1:
        raise ValueError(f"devices {devices} < 1")
    if cuda and devices > torch.cuda.device_count():
        raise ValueError(f"--devices {devices} but only "
                         f"{torch.cuda.device_count()} CUDA devices")
    if devices == 1:
        return fn(*args)
    backend = "nccl" if cuda else "gloo"
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        if int(os.environ["WORLD_SIZE"]) != devices:
            raise ValueError(f"--devices {devices} under torchrun's world of "
                             f"{os.environ['WORLD_SIZE']}")
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        maybe_initialize_distributed(backend=backend)
        try:
            return fn(*args)
        finally:
            dist.destroy_process_group()
    spawn_workers(_on_device, devices, fn, cuda, args, backend=backend)
    return None


def rank_device(device) -> torch.device:
    """This rank's device of ``device``'s type: the current CUDA device
    (``run_on_devices`` sets it per rank), or the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return device
