"""Multi-process initialization.

Port of ``lithographysimulator_tpu/parallel/distributed.py``. One process
over the cards it sees needs nothing: the meshes of :mod:`.mesh` span them.
Across processes (several hosts, or a process a card), call
:func:`initialize` once a process before the collective work: it starts a
``torch.distributed`` process group (NCCL for CUDA, gloo for the CPU) and
reports the topology under the JAX package's four keys. Nothing on a host
tells a program of its cluster, so the caller passes the coordinator's
address, the process count and this process's index (or sets torch's
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` and passes none).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _init_method(coordinator_address) -> str:
    if coordinator_address is None:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               *, device="cuda", **kwargs) -> dict:
    """Start the process group (nothing if one is already running) and
    report ``process_index``, ``process_count``, ``local_devices`` (this
    process's CUDA devices, or 1 on the CPU) and ``global_devices`` (the
    all-reduced sum of every process's). ``coordinator_address`` is
    ``host:port`` (as in JAX) or a torch init URL; ``kwargs`` go to
    ``torch.distributed.init_process_group``."""
    cuda = torch.device(device).type == "cuda"
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if cuda else "gloo",
            init_method=_init_method(coordinator_address),
            world_size=-1 if num_processes is None else int(num_processes),
            rank=-1 if process_id is None else int(process_id), **kwargs)
    local = torch.cuda.device_count() if cuda else 1
    if cuda:
        torch.cuda.set_device(dist.get_rank() % max(local, 1))
        count = torch.tensor([local], device="cuda")
    else:
        count = torch.tensor([local])
    dist.all_reduce(count)
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": local,
        "global_devices": int(count.item()),
    }
