"""Multi-process runtime: process group, backend, pod mesh, per-rank feeds.

Port of the JAX package's ``parallel/multihost.py`` on
``torch.distributed``:

  initialize_runtime()  — ``init_process_group`` when the process is one
                          rank of a world (explicit flags, the GRB_*
                          environment, or torchrun's); an idempotent no-op
                          that returns False otherwise, so every entry
                          point may call it unconditionally.
  choose_backend()      — NCCL when every rank of the host has a card of
                          its own, gloo when ranks share a card or run on
                          the CPU (NCCL refuses two ranks on one card).
                          Chosen from the layout before the group starts,
                          never by catching a failed NCCL start.
  make_pod_mesh()       — the world as a ``Mesh`` (parallel/mesh.py).
  HostBatchFeed         — every rank derives the SAME epoch permutation
                          from the shared numpy seed and keeps only its
                          contiguous share of every batch, a tensor on its
                          device.

Each rank's device is ``cuda:(local_rank % device_count)`` unless the
caller asks for the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh

# set by initialize_runtime: {"backend", "device", "rank", "world",
# "local_rank", "local_world"}
RUNTIME: dict = {}
INIT_TIMEOUT_S = 600


def _init_method(address: str) -> str:
    """A coordinator as torch.distributed's init method: 'host:port' means
    tcp://host:port; tcp:// and file:// URLs pass as they are."""
    if "://" in address:
        return address
    return f"tcp://{address}"


def resolve_runtime(coordinator_address=None, num_processes=None, process_id=None,
                    environ=None):
    """(init_method, world_size, rank) of this process, or None for a
    single-process run, in the JAX package's resolution order (first hit
    wins, field by field for the first two):
      1. explicit arguments (CLI --dist_coordinator/--dist_nprocs/--dist_rank);
      2. GRB_COORDINATOR / GRB_NUM_PROCESSES / GRB_PROCESS_ID;
      3. torchrun's MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK (the
         counterpart of JAX's cloud auto-detection);
      4. None."""
    env = os.environ if environ is None else environ
    coordinator_address = coordinator_address or env.get("GRB_COORDINATOR")
    if num_processes is None and env.get("GRB_NUM_PROCESSES"):
        num_processes = int(env["GRB_NUM_PROCESSES"])
    if process_id is None and env.get("GRB_PROCESS_ID"):
        process_id = int(env["GRB_PROCESS_ID"])
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError(
                f"coordinator {coordinator_address!r} needs the world size and this "
                "process's rank (--dist_nprocs/--dist_rank or GRB_NUM_PROCESSES/"
                "GRB_PROCESS_ID)")
        return _init_method(coordinator_address), int(num_processes), int(process_id)
    if env.get("MASTER_ADDR"):
        port = env.get("MASTER_PORT", "29500")
        return (f"tcp://{env['MASTER_ADDR']}:{port}", int(env["WORLD_SIZE"]),
                int(env["RANK"]))
    return None


def choose_backend(device_type: str, local_world: int, device_count: int):
    """(backend, reason): NCCL when every local rank has a card of its
    own, else gloo (ranks sharing a card, or on the CPU)."""
    if device_type == "cpu":
        return "gloo", "ranks on the CPU"
    if local_world <= device_count:
        return "nccl", f"{local_world} local ranks on {device_count} cards, one card each"
    return "gloo", f"{local_world} local ranks share {device_count} card(s)"


def check_backend(backend: str, device_type: str, local_world: int, device_count: int):
    """Refuse a backend that cannot serve the layout: NCCL with ranks that
    share a card or on the CPU."""
    if backend == "nccl" and (device_type == "cpu" or local_world > device_count):
        raise ValueError(
            f"backend nccl refused: {local_world} local ranks on "
            f"{'the CPU' if device_type == 'cpu' else f'{device_count} card(s)'}; NCCL "
            "needs one card a rank (two ranks on one card: 'Duplicate GPU detected'); "
            "use gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")


def initialize_runtime(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None, device=None,
                       backend: Optional[str] = None) -> bool:
    """Start this process's rank of the world; True when it is one (a
    second call is a no-op that returns True), False for a single-process
    run.  `device` 'cpu' keeps the rank on the CPU; otherwise its card is
    cuda:(local_rank % device_count), made current.  `backend` None
    chooses from the layout (choose_backend); an explicit one the layout
    cannot serve raises before the group starts.  Prints the choice."""
    if dist.is_available() and dist.is_initialized():
        return True
    resolved = resolve_runtime(coordinator_address, num_processes, process_id)
    if resolved is None:
        return False
    init_method, world, rank = resolved
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if on_cpu:
        dev = torch.device("cpu")
        count = 0
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                               "ranks on the CPU")
        count = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    auto, reason = choose_backend(dev.type, local_world, count)
    if backend is None:
        backend = auto
    else:
        check_backend(backend, dev.type, local_world, count)
        reason = "asked for"
    print(f"rank {rank}/{world}: backend {backend} ({reason}); device {dev}; "
          f"init {init_method}", flush=True)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S), **kw)
    RUNTIME.update(backend=backend, device=dev, rank=rank, world=world,
                   local_rank=local_rank, local_world=local_world)
    return True


def runtime_device():
    """The device initialize_runtime gave this rank (None before it)."""
    return RUNTIME.get("device")


def make_pod_mesh(dp: Optional[int] = None, mp: int = 1, device=None) -> Mesh:
    """The world as a (dp, mp) Mesh, this process's rank and device in it,
    in the JAX layout rank = d * mp + m (JAX multihost.py:81-104).
    Single-process: a mesh of one.  dp defaults to world / mp; dp * mp must
    span the world, and in a world of several hosts mp must divide the
    ranks of one host (the JAX assertion: the table's exchanges stay inside
    a host).  Every rank creates every axis group, in the same order (dp's
    lines, then mp's), or ``new_group`` hangs; an axis that spans the world
    uses the world's group.  `device` defaults to the runtime's (else the
    current card)."""
    started = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if started else 1
    rank = dist.get_rank() if started else 0
    if mp < 1 or world % mp:
        raise ValueError(f"mp {mp} does not divide the world of {world} rank(s)")
    if dp is None:
        dp = world // mp
    if dp * mp != world:
        raise ValueError(f"dp {dp} x mp {mp} must span the world of {world} rank(s)")
    local = RUNTIME.get("local_world", world)
    if mp > 1 and local != world and local % mp:
        raise ValueError(f"mp {mp} must divide the {local} ranks of one host")
    groups = {}
    if started and 1 < mp < world:
        for d in range(dp):
            g = dist.new_group([d * mp + m for m in range(mp)])
            if rank // mp == d:
                groups["mp_group"] = g
        for m in range(mp):
            g = dist.new_group([d * mp + m for d in range(dp)])
            if rank % mp == m:
                groups["dp_group"] = g
    if device is None:
        device = runtime_device()
    if device is None:
        from ..device import resolve_device

        device = resolve_device(None)
    return Mesh(dp=dp, mp=mp, rank=rank, device=torch.device(device), **groups)


def process_local_rows(n_rows: int, mesh: Mesh) -> slice:
    """The contiguous slice of a [n_rows, ...] batch that this rank owns:
    the batch splits over every rank of the mesh (dp * mp; edge and a2a
    meshes have mp 1), rank r taking the r-th share."""
    if n_rows % mesh.size:
        raise ValueError(f"{n_rows} rows do not split over {mesh.size} ranks")
    per = n_rows // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def global_batch(local_np, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a global batch as a tensor on its device (the
    JAX package assembles the global array from every process's rows; here
    each rank computes on its own)."""
    return torch.as_tensor(np.ascontiguousarray(local_np)).to(mesh.device)


class HostBatchFeed:
    """Per-rank epoch feed: the epoch permutation of the JAX feed
    (``np.random.default_rng(epoch_seed).permutation``), padded to whole
    batches with mask 0, and this rank's share of every batch.
    ``batches(epoch_seed)`` yields (rows int32, mask f32) on the mesh's
    device."""

    def __init__(self, n_rows: int, batch_size: int, mesh: Mesh):
        self.n_rows = int(n_rows)
        self.batch_size = int(batch_size)
        self.num_batches = -(-self.n_rows // self.batch_size)
        self.mesh = mesh
        self.local = process_local_rows(self.batch_size, mesh)

    def batches(self, epoch_seed: int):
        rng = np.random.default_rng(epoch_seed)
        perm = rng.permutation(self.n_rows).astype(np.int32)
        pad = self.num_batches * self.batch_size - self.n_rows
        perm = np.concatenate([perm, np.zeros(pad, dtype=np.int32)])
        mask = (np.arange(self.num_batches * self.batch_size) < self.n_rows).astype(
            np.float32)
        perm = perm.reshape(self.num_batches, self.batch_size)
        mask = mask.reshape(self.num_batches, self.batch_size)
        sl = self.local
        for b in range(self.num_batches):
            yield global_batch(perm[b, sl], self.mesh), global_batch(mask[b, sl], self.mesh)
