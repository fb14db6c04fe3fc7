"""Joining processes into one mesh: the ``torch.distributed`` glue.

The port of ``hypergraphdb_tpu/parallel/multihost.py``. Each process
holds its own shards of a :class:`~.sharded.Mesh`; the mesh's two
collectives finish across processes through the process group that
:func:`initialize` sets up (nccl on the cards; gloo when asked, for a
mesh of CPUs)::

    from hypergraphdb_tpu_torch.parallel import multihost
    multihost.initialize("tcp://10.0.0.1:8476", num_processes=4,
                         process_id=int(os.environ["RANK"]))
    mesh = multihost.global_mesh()          # this process's shards
    sdev = ShardedSnapshot.from_host(snap, mesh)

A single process skips ``initialize``, and :func:`global_mesh` is the
mesh of its visible cards. Where no card is visible, :func:`global_mesh`
and :func:`local_process_info` raise unless given the devices
(``devices=["cpu"] * 4``).
"""

from __future__ import annotations

from typing import Optional

import torch

from hypergraphdb_tpu_torch.parallel.sharded import AXIS, Mesh, make_mesh

_initialized = False


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "nccl") -> None:
    """Join the process group (``torch.distributed.init_process_group``),
    once per process. ``coordinator`` is the rendezvous address
    (``tcp://host:port``, or ``host:port``); with none, the group reads
    the usual environment variables. ``backend`` is nccl (the cards);
    a mesh of CPUs asks for ``"gloo"``."""
    global _initialized
    if _initialized:
        return
    import torch.distributed as dist

    kw = {}
    if coordinator is not None:
        kw["init_method"] = (coordinator if "://" in coordinator
                             else f"tcp://{coordinator}")
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    dist.init_process_group(backend, **kw)
    _initialized = True


def _group() -> Optional[tuple[int, int]]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return None


def is_multihost() -> bool:
    """Whether the process group holds more than one process."""
    g = _group()
    return g is not None and g[0] > 1


def _local_devices(devices=None) -> list:
    """``devices``, or every visible CUDA device; raises when there is
    none, as ``make_mesh`` does (a CPU mesh is asked for by name)."""
    if devices is not None:
        return list(devices)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "multihost: no CUDA device is visible; pass the devices, "
            "e.g. ['cpu'] * 4")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def global_mesh(axis: str = AXIS, devices=None) -> Mesh:
    """One-axis mesh over every process's shards: ``devices`` (this
    process's, default its visible cards) times the world size. Without a
    process group it is the local devices' mesh. With several processes
    and no ``devices``, each process takes one card (its rank modulo the
    cards it sees). Raises when ``devices`` is None and no card is
    visible."""
    local = _local_devices(devices)
    if devices is None:
        g = _group()
        if g is not None and g[0] > 1:
            local = [local[g[1] % len(local)]]
    return make_mesh(local, axis)


def local_process_info(devices=None) -> dict:
    """This process's place in the group: the reference's four keys.
    ``devices`` are this process's shards (default its visible cards;
    raises when there is none)."""
    g = _group() or (1, 0)
    n_local = len(_local_devices(devices))
    return {
        "process_index": g[1],
        "process_count": g[0],
        "local_devices": n_local,
        "global_devices": n_local * g[0],
    }
