"""A cell over several ranks: one process a card, as torchrun starts them.

`launch` builds the port's CUDA library once, then starts one process per
rank with the `spawn` start method, each with torchrun's environment
(RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT),
and waits.  Each rank joins a process group of its own making (NCCL on
cuda:LOCAL_RANK; gloo on the CPU for the tests), whose collectives time
out after `TIMEOUT` rather than the port's hour, and runs the cell through
`run_cell`, which hands it to `harness/rank_train.py`.  Every rank sends
the parent the steps it ran in the window, rank 0 its result too; the
parent returns rank 0's result, which `run.py` prints, so that the result
line and the checks come last, after every rank has ended.

A rank that exits non-zero, or ends without its message, ends the run: the
parent kills the other ranks and returns None.  A rank also dies with the
parent (PR_SET_PDEATHSIG), so nothing outlives a run that is killed.
"""

from __future__ import annotations

import ctypes
import datetime
import os
import signal
import socket
import sys
import traceback
from multiprocessing import connection, get_context
from typing import Callable, Dict, Optional

TIMEOUT = datetime.timedelta(minutes=3)
LIBRARY = "epipolar_attention"  # the port's one CUDA library (csrc/<name>.cu)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def rank_main(rank: int, world: int, port: int, backend: str, cell, seed: int,
              seconds: float, trace: bool, t_start: float, conn) -> None:
    """One rank: join the group, run the cell, send the parent
    {"rank", "steps", "result" (rank 0's, else None)}."""
    _die_with_parent()
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
        if backend == "nccl":
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # the ranks share one host
        import torch
        import torch.distributed as dist

        from . import forbidden_modules, run_cell

        if backend == "nccl":
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
            dist.init_process_group("nccl", init_method="env://", rank=rank, world_size=world,
                                    timeout=TIMEOUT, device_id=device)
        else:
            device = torch.device("cpu")
            torch.set_num_threads(2)
            dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world,
                                    timeout=TIMEOUT)
        result = run_cell(cell, seed, seconds, trace and rank == 0, device, t_start)
        found = forbidden_modules()
        if found:
            raise RuntimeError(f"rank {rank} loaded {found}")
        if rank == 0:
            kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
            result["device"] = {"platform": "gpu" if device.type == "cuda" else "cpu",
                                "kind": kind, "count": world, **result["device"]}
        conn.send({"rank": rank, "steps": result["attempted"],
                   "result": result if rank == 0 else None})
        conn.close()
    except BaseException:  # noqa: BLE001 - a rank reports any failure and exits non-zero at once
        traceback.print_exc()
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(1)  # no teardown: the other ranks may be waiting in a collective


def launch(cell, seed: int, seconds: float, trace: bool, t_start: float,
           world: Optional[int] = None, backend: str = "nccl",
           target: Callable = rank_main) -> Optional[Dict]:
    """Run `cell` over `world` ranks (its `chips` by default); rank 0's
    result, or None where a rank failed (the others are then killed)."""
    world = world or cell.chips
    if backend == "nccl":  # build once here, not in every rank at once
        from epipolar_transformers_tpu_torch.ops._build import load_library

        load_library(LIBRARY)
    ctx = get_context("spawn")
    port = free_port()
    procs, readers = [], {}
    try:
        for r in range(world):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=target, name=f"bench-rank-{r}",
                            args=(r, world, port, backend, cell, seed, seconds, trace, t_start,
                                  send))
            p.start()
            send.close()
            procs.append(p)
            readers[recv] = r
        messages: Dict[int, Dict] = {}
        while readers or any(p.exitcode is None for p in procs):
            waiting = list(readers) + [p.sentinel for p in procs if p.exitcode is None]
            for ready in connection.wait(waiting, timeout=5.0):
                if ready in readers:
                    try:
                        messages[readers[ready]] = ready.recv()
                    except EOFError:
                        pass
                    del readers[ready]
            bad = [(p.name, p.exitcode) for p in procs if p.exitcode not in (None, 0)]
            if bad:
                print(f"h100_bench: {bad} exited non-zero; the other ranks are stopped",
                      file=sys.stderr)
                return None
        steps = {m["steps"] for m in messages.values()}
        if len(messages) != world or len(steps) != 1 or messages[0]["result"] is None:
            print(f"h100_bench: the ranks sent {sorted(messages)} of {world} messages, steps "
                  f"{sorted(steps)}", file=sys.stderr)
            return None
        return messages[0]["result"]
    finally:
        for p in procs:
            if p.exitcode is None:
                p.terminate()
        for p in procs:
            p.join(10.0)
            if p.exitcode is None:
                p.kill()
                p.join()
        # spawn started multiprocessing's resource tracker, which would end
        # only after this process; `_stop` ends it and waits (no public call)
        from multiprocessing import resource_tracker

        resource_tracker._resource_tracker._stop()
