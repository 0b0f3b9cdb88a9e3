"""Data parallel over processes: the counterpart of the JAX package's
parallel/mesh.py.

The JAX package shards the batch over a 1-D device mesh, and under GSPMD
every batch reduction (the gradient mean, BatchNorm's moments) is global.
The port runs one process ("rank") per device under a torch.distributed
process group, and makes the same reductions global by hand:
DistributedDataParallel averages the gradients (engine/trainer.py),
`models/layers.BatchNorm2d` all-reduces its moments in training, and
`global_ratio` divides a count-normalised loss by the global count.

`init_distributed` joins the group that torchrun's environment describes
(`--multihost`).  The other helpers read the *default* process group,
whoever made it, so a test may make a gloo group itself; without one the
world is 1.  A group of one rank (torchrun --nproc_per_node 1) runs every
collective all the same, as each rank of a larger group does.  Inside
`alone()` (the work rank 0 does by itself: its checkpoints and its eval)
they read no group, so nothing there waits on the other ranks.

Batch semantics follow the JAX package: a JAX process drives all of its
host's devices, and SOLVER.IMS_PER_BATCH is one process's batch (JAX
data/pipeline.py:make_data_loader).  A port rank stands for one JAX
device, so the ranks of a host (LOCAL_WORLD_SIZE of them) split the host's
batch, each taking IMS_PER_BATCH // LOCAL_WORLD_SIZE items; a remainder
raises, as JAX `shard_batch` does.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Dict

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

__all__ = ["all_sum", "all_sum_differentiable", "alone", "barrier", "check_same_on_every_rank",
           "distributed", "global_ratio", "host", "hosts", "init_distributed", "is_primary", "local_rank",
           "local_world", "mean_over_ranks", "per_rank_batch", "rank", "shutdown", "world"]

# how long a collective waits for the other ranks: rank 0's eval runs
# while the others wait at a barrier
TIMEOUT = datetime.timedelta(minutes=60)

_alone = 0


def init_distributed(device=None) -> torch.device:
    """Join the process group of torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return this rank's device:
    cuda:LOCAL_RANK under NCCL, unless the caller asked for the CPU
    (`device` "cpu"), which joins over gloo."""
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in env]
    if missing:
        raise RuntimeError(f"--multihost reads torchrun's environment, and {missing} are "
                           "not set: start the ranks with torchrun")
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        device, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("--multihost runs a rank per GPU, but torch sees no GPU; ask "
                               "for the CPU (--device cpu) to run the ranks there over gloo")
        device, backend = torch.device("cuda", int(env.get("LOCAL_RANK", 0))), "nccl"
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://", rank=int(env["RANK"]),
                            world_size=int(env["WORLD_SIZE"]), timeout=TIMEOUT)
    return device


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def distributed() -> bool:
    """Whether this process trains in a process group, of any size: DDP
    wraps the model and the batch reductions run as collectives.  False
    without a group, and inside `alone()`."""
    return not _alone and dist.is_available() and dist.is_initialized()


def world() -> int:
    """Ranks in the default process group; 1 without one, and inside
    `alone()`."""
    return dist.get_world_size() if distributed() else 1


def rank() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if distributed() else 0


def is_primary() -> bool:
    return rank() == 0


def local_world() -> int:
    """Ranks on this host: LOCAL_WORLD_SIZE (torchrun sets it), else the
    whole world (a group made by hand on one host)."""
    if world() == 1:
        return 1
    n = int(os.environ.get("LOCAL_WORLD_SIZE", world()))
    if n < 1 or world() % n:
        raise ValueError(f"LOCAL_WORLD_SIZE {n} does not divide the world of {world()} ranks")
    return n


def local_rank() -> int:
    """This rank's place among its host's ranks (torchrun numbers a host's
    ranks contiguously)."""
    return rank() % local_world()


def host() -> int:
    return rank() // local_world()


def hosts() -> int:
    return world() // local_world()


def per_rank_batch(host_batch: int, ranks_per_host: int) -> int:
    """One rank's share of its host's batch; raises on a remainder, where
    the JAX package's `shard_batch` raises."""
    if host_batch % ranks_per_host:
        raise ValueError(f"SOLVER.IMS_PER_BATCH {host_batch} (one host's batch) does not "
                         f"split over the host's {ranks_per_host} ranks; make it a multiple "
                         f"of LOCAL_WORLD_SIZE")
    return host_batch // ranks_per_host


@contextlib.contextmanager
def alone():
    """Work this rank does by itself while the others wait (rank 0's
    checkpoints and eval): inside, the helpers read a world of 1, so no
    collective runs and BatchNorm in training takes this rank's moments, as
    a one-process run would."""
    global _alone
    _alone += 1
    try:
        yield
    finally:
        _alone -= 1


def barrier() -> None:
    if distributed():
        dist.barrier()


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, without a gradient (a copy)."""
    t = t.detach().clone()
    if distributed():
        dist.all_reduce(t)
    return t


def all_sum_differentiable(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, with the gradient of that sum (the
    sum of the ranks' gradients)."""
    return dist_nn.all_reduce(t) if distributed() else t


def global_ratio(num: torch.Tensor, den: torch.Tensor, min_den: float = 1.0) -> torch.Tensor:
    """`num / max(den, min_den)` with the denominator taken over the global
    batch, as GSPMD computes a count-normalised loss.  Under a world of W,
    rank r returns W num_r / max(sum_q den_q, min_den): DDP's mean of the
    ranks' gradients is then the gradient of the global ratio, and the
    ranks' mean loss is its value.  The count carries no gradient there."""
    if not distributed():
        return num / torch.clamp(den, min=min_den)
    return num * world() / torch.clamp(all_sum(den), min=min_den)


def mean_over_ranks(values: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each scalar averaged over the ranks (every rank must call this)."""
    if not values:
        return {}
    keys = list(values)
    stacked = torch.stack([values[k].detach().double().reshape(()) for k in keys])
    return dict(zip(keys, (all_sum(stacked) / world()).tolist()))


def check_same_on_every_rank(module: torch.nn.Module) -> None:
    """Raise unless every rank holds bit-equal parameters and buffers: rank
    0's are broadcast and compared, once, before training."""
    if world() == 1:
        return
    mine = [t.detach() for t in module.state_dict().values() if t.is_floating_point()]
    flat = torch.cat([t.reshape(-1).double() for t in mine])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    bad = torch.ne(flat, ref).any().reshape(1).int()
    dist.all_reduce(bad)
    if int(bad.item()):
        raise RuntimeError(f"the ranks' initial weights differ (rank {rank()} of {world()}); "
                           "every rank must draw the same seeded init and load the same files")
