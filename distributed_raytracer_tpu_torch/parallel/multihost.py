"""Multi-process execution: torch.distributed glue + process-0 frame assembly.

The torch counterpart of distributed_raytracer_tpu/parallel/multihost.py,
the analog of the reference's master/worker topology (a master and N
networked workers, master/registrar.go:25-67, worker/distributed/
main.go:146-185):
  - `initialize()` joins N OS processes into one job through a TCP
    coordinator (`init_process_group`, with a timeout, so a lost peer fails
    the run instead of hanging it), the analog of the worker registration
    loop;
  - `global_mesh()` is the mesh of every rank of the job
    (parallel/mesh.ProcessMesh): each process runs its own ranks on its
    own device, and the collectives of parallel/mesh.py cross processes;
  - process 0 plays the master's role (assembly, display, the report),
    and `gather_frame` gives it the frame (the analog of coordinator tile
    reassembly, master/main.go:163-177).

The transport is chosen once, in `initialize`, from the layout, and
returned for the caller to print: NCCL when every process owns a card of
its own (the processes compare their cards' UUIDs), else gloo, which
stages every crossing chunk through host memory (two processes on one
card, where NCCL refuses two ranks, or CPU ranks). It is never a retry
after a failure, and nothing falls back to the CPU: each process renders
on its own device. Small host values the processes must agree on (work-list
counts, the balanced band layout, bake checksums) go over a gloo group.

Single-process mode works unchanged: with neither a coordinator nor a
process count, `initialize` does nothing and `global_mesh` is the local
mesh.
"""

from __future__ import annotations

import datetime
import socket
from typing import Optional

import numpy as np
import torch

from distributed_raytracer_tpu_torch.parallel import mesh as mesh_mod

# A collective that waits longer than this for a peer raises.
TIMEOUT_S = 300.0

_transport: Optional[mesh_mod.Transport] = None
_devices: tuple = ()     # every process's device, as that process names it


def process_device(process_id: int, device=None) -> torch.device:
    """The device a process renders on: "cpu", "cuda:k", or "cuda" (the
    default): card process_id % device_count, so each process owns a card
    while there are enough."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but CUDA is not "
                               "available")
        dev = torch.device(f"cuda:{process_id % torch.cuda.device_count()}")
    return dev


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None) -> Optional[mesh_mod.Transport]:
    """Join the job (a no-op for single-process runs, returning None).

    Process 0 binds `coordinator_address` (HOST:PORT); every process blocks
    until all `num_processes` have joined. Returns the transport the
    collectives use."""
    global _transport, _devices
    if num_processes is None and coordinator_address is None:
        return None  # single-process
    if coordinator_address is None or num_processes is None or \
            process_id is None:
        raise ValueError("a multi-process run needs the coordinator "
                         "address, the process count and this process's id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in "
                         f"[0, {num_processes})")
    dist = torch.distributed
    dev = process_device(process_id, device)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    ident = "cpu"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        ident = (f"{socket.gethostname()} "
                 f"{torch.cuda.get_device_properties(dev).uuid}")
    found = [None] * num_processes
    dist.all_gather_object(found, (str(dev), ident))
    _devices = tuple(torch.device(d) for d, _ in found)
    kinds = {d.type for d in _devices}
    if len(kinds) > 1:
        raise ValueError(f"processes render on cpu and cuda: "
                         f"{[str(d) for d in _devices]}")
    own_cards = (dev.type == "cuda"
                 and len({i for _, i in found}) == num_processes)
    group = dist.group.WORLD
    if own_cards:
        group = dist.new_group(backend="nccl", timeout=timeout)
        # The communicator forms now, with every process present.
        warm = torch.zeros(1, device=dev)
        dist.all_reduce(warm, group=group)
        torch.cuda.synchronize(dev)
    _transport = mesh_mod.Transport(
        process=process_id, n_procs=num_processes,
        backend="nccl" if own_cards else "gloo", group=group,
        host_group=dist.group.WORLD)
    return _transport


def is_master() -> bool:
    """Whether this process plays the master's role (process 0)."""
    return _transport is None or _transport.process == 0


def global_mesh(n_ranks: Optional[int] = None, device="cuda") -> tuple:
    """The mesh of every rank of the job: n_ranks (default one per process)
    split evenly over the processes, rank i in process i // (n_ranks /
    processes), on that process's device (several ranks of one process
    share it). In a single-process run, mesh.default_mesh(n_ranks,
    device)."""
    if _transport is None:
        return mesh_mod.default_mesh(n_ranks, device)
    n_procs = _transport.n_procs
    n_ranks = n_procs if n_ranks is None else n_ranks
    if n_ranks < 1 or n_ranks % n_procs:
        raise ValueError(f"{n_ranks} ranks do not split evenly over "
                         f"{n_procs} processes")
    per = n_ranks // n_procs
    procs = [r // per for r in range(n_ranks)]
    return mesh_mod.ProcessMesh([_devices[p] for p in procs], procs,
                                _transport)


def gather_frame(frame) -> Optional[np.ndarray]:
    """The frame as numpy on the master process, None elsewhere. The
    multi-rank renderers already bring their frames to process 0 (their
    mesh.gather); a frame every process rendered alone (sequential and
    culled modes) is process 0's."""
    if frame is None or not is_master():
        return None
    return frame.detach().cpu().numpy()


def shutdown() -> None:
    """Leave the job (a no-op in a single-process run)."""
    global _transport, _devices
    if _transport is None:
        return
    torch.distributed.destroy_process_group()
    _transport, _devices = None, ()
