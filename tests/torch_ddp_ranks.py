"""Rank programs for the port's data-parallel tests.

Each rank runs in a process of its own (multiprocessing's spawn), joins a
gloo group over localhost itself, does its part, and writes what the test
compares to `<out>/rank<r>.pt`; an error goes to `<out>/rank<r>.err`.
This module imports only the standard library at the top, so a rank may
block modules (`blocked`) before it imports torch and the port, and a
loader's forkserver may import it cheaply.
"""

import os
import pickle
import socket
import sys
import traceback

# a rank waits this long for the other ranks (a hung group fails the test)
RANK_TIMEOUT = 240.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Draws:
    """An io-bound dataset whose item is its index and one draw of the
    stream its loader worker reseeded (what the JointsDataset family draws
    from); here, not in a test module, so that the loader's forkserver
    imports no JAX."""

    io_bound = True

    def __init__(self, n):
        self.n = n
        self.reseed(0)

    def reseed(self, seed):
        import numpy as np

        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        import numpy as np

        return {"i": np.asarray(i), "draw": np.asarray(self.rng.randint(2 ** 31))}


def run_ranks(body: str, world: int, out_dir: str, *args, timeout: float = RANK_TIMEOUT):
    """Run `body`(rank, world, *args), a function of this module, in
    `world` spawned processes (`rank_entry`); raise with a rank's error if
    any fails or outlives `timeout`; returns each rank's result."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=rank_entry, args=(r, world, port, out_dir, body, args),
                         name=f"gloo-rank-{r}") for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    errors = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if alive or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"ranks alive after {timeout} s: {[p.name for p in alive]}; exit "
                             f"codes {[p.exitcode for p in procs]}\n" + "\n".join(errors))
    import torch

    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def rank_entry(rank, world, port, out_dir, body, args):
    """One rank: join a gloo group on `port` (the command line joins its
    own, from the torchrun environment that `cli_rank` sets), run `body`,
    leave; write the result, or the error."""
    try:
        if body == "cli_rank":
            result = cli_rank(rank, world, port, *args)
        else:
            import torch
            import torch.distributed as dist

            torch.set_num_threads(1)
            dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                    world_size=world)
            try:
                result = globals()[body](rank, world, *args)
            finally:
                dist.destroy_process_group()
        import torch

        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def step_rank(rank, world, payload_path, steps):
    """The train step of tests/test_torch_parallel.py on this rank's
    contiguous share of the batch, in f64 on one thread, under DDP."""
    import torch

    from epipolar_transformers_tpu_torch import parallel
    from epipolar_transformers_tpu_torch.engine.solver import make_optimizer
    from epipolar_transformers_tpu_torch.engine.trainer import data_parallel, make_train_step
    from epipolar_transformers_tpu_torch.models import ModelBuilder, epipolar
    from epipolar_transformers_tpu_torch.models.layers import BatchNorm2d
    from epipolar_transformers_tpu_torch.utils.jax_import import load_jax_variables

    with open(payload_path, "rb") as f:
        payload = pickle.load(f)
    cfg, inputs, locs = payload["cfg"], payload["inputs"], payload["locs"]
    n = len(locs) // world
    share = slice(rank * n, (rank + 1) * n)
    inputs = {k: v[share] for k, v in inputs.items()}
    # the JAX sample locations the one-process run took (the parity
    # tests hold the layer, not the two f32 geometries)
    epipolar.epipolar_sample_locs = lambda P1, P2, geom, grid=None: locs[share]

    model = ModelBuilder(cfg)
    load_jax_variables(model, payload["variables"])
    model.double().train()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    optimizer = make_optimizer(cfg, model)
    train_step = make_train_step(cfg, data_parallel(cfg, model, torch.device("cpu")), optimizer)
    out = {"share": (share.start, share.stop)}
    for step in range(steps):
        metrics = train_step(inputs)
        if step == 0:
            out["loss"] = float(metrics["loss"])
            out["mean_loss"] = parallel.mean_over_ranks(metrics)["loss"]
            out["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
            out["state"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["params"] = {k: p.detach().clone() for k, p in model.named_parameters()}

    # the guard: a BatchNorm that would train on this rank's moments raises
    bn = BatchNorm2d(3).double().train()
    bn.sync = False
    try:
        bn(torch.ones(2, 3, 2, 2, dtype=torch.float64))
        out["guard"] = None
    except ValueError as exc:
        out["guard"] = str(exc)
    local = torch.nn.Sequential(torch.nn.Conv2d(3, 3, 1), torch.nn.BatchNorm2d(3))
    try:
        data_parallel(cfg, local, torch.device("cpu"))
        out["ddp_guard"] = None
    except ValueError as exc:
        out["ddp_guard"] = str(exc)
    return out


def one_rank_group(rank, world):
    """In a group of one rank: what trains (DDP or the model), the
    all-reduces a BatchNorm in training calls, its output and running
    statistics against the same BatchNorm's outside the group (`alone`),
    and whether a BatchNorm with `sync` off still trains."""
    import torch
    import torch.distributed as dist

    from epipolar_transformers_tpu_torch import parallel
    from epipolar_transformers_tpu_torch.config import flagship_cfg
    from epipolar_transformers_tpu_torch.engine.trainer import data_parallel
    from epipolar_transformers_tpu_torch.models import ModelBuilder
    from epipolar_transformers_tpu_torch.models.layers import BatchNorm2d

    cfg = flagship_cfg(tiny=True)
    trained = type(data_parallel(cfg, ModelBuilder(cfg), torch.device("cpu"))).__name__
    x = torch.randn(3, 4, 5, 5, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    calls, all_reduce = [0], dist.all_reduce

    def counted(*args, **kwargs):
        calls[0] += 1
        return all_reduce(*args, **kwargs)

    bns = [BatchNorm2d(4).double().train() for _ in range(2)]
    dist.all_reduce = counted
    try:
        grouped = bns[0](x)
        with parallel.alone():
            alone = bns[1](x)
    finally:
        dist.all_reduce = all_reduce
    local = BatchNorm2d(4).double().train()
    local.sync = False
    local(x)
    return {"trained": trained, "all_reduces": calls[0], "out": (grouped, alone),
            "running": [(b.running_mean.clone(), b.running_var.clone()) for b in bns]}


def loss_rank(rank, world, cases):
    """Each count-normalised loss on this rank's share, under DDP's mean of
    the ranks' gradients: (loss, gradient of the shared weight) per case."""
    from epipolar_transformers_tpu_torch import parallel

    out = {}
    for name, (fn, weight, args, shared) in cases.items():
        n = len(args[0]) // world
        share = [a[rank * n:(rank + 1) * n] if i not in shared else a for i, a in enumerate(args)]
        w = weight.clone().requires_grad_()
        loss = fn(w * share[0], *share[1:])
        loss.backward()
        out[name] = (parallel.mean_over_ranks({"loss": loss})["loss"],
                     parallel.all_sum(w.grad) / world)
    return out


def cli_rank(rank, world, port, argv, blocked=()):
    """The port's command line with --multihost on this rank, torchrun's
    environment set by hand; none of the `blocked` modules may load."""
    for name in blocked:
        sys.modules[name] = None
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    import torch

    torch.set_num_threads(1)
    from epipolar_transformers_tpu_torch.main import main

    results = main(argv)
    loaded = sorted(m for m, v in sys.modules.items()
                    if v is not None and m.split(".")[0] in blocked)
    return {"results": results, "loaded": loaded}
