"""Host batching for the port.

`collate` stacks items as the JAX package's does
(epipolar_transformers_tpu/data/pipeline.py).  `make_train_loader` and
`make_eval_loaders` are the two halves of the JAX `make_data_loader`: a
`TrainLoader` that gives the JAX `DataLoader`'s shuffled order for the same
seed (tests/test_torch_config.py holds the two equal), and one
`EvalLoader` per DATASETS.TEST in order, whose batches of TEST.IMS_PER_BATCH
(B, V, ...) view groups the eval engine takes.  Each batch is a fresh host
buffer, so it may be copied to the device asynchronously and kept as long
as the caller likes.

Datasets that read and decode files (`io_bound`, the JointsDataset family)
and whose draws can be reseeded take DATALOADER.NUM_WORKERS worker
processes (`_worker_batches`), the other datasets are read in the calling
process.  The batch order is the same with 0 or N workers.  Worker w
draws from its dataset reseeded with (cfg.SEED, epoch, w + 1) and takes
the epoch's items w, w + N, ... in batch order, so a run is deterministic
for a given N and a batch's items are made in parallel; with 0 workers
the dataset's own stream, seeded with cfg.SEED, gives the JAX package's
items.

Under a process group (parallel/) each rank loads its own share, as the
JAX package's processes do (JAX `DataLoader._indices`): host h of H takes
the epoch's order `idx[h::H]` in batches of SOLVER.IMS_PER_BATCH, and the
host's L ranks split each such batch into contiguous slices, rank l taking
the l-th; the slices concatenated in rank order are the JAX batch in mesh
order, and on one host the single-rank batch.  DATALOADER.NUM_WORKERS is
the host's too: each of its L ranks starts N = max(1, NUM_WORKERS // L)
workers.  Rank r's worker w draws
from its dataset reseeded with (cfg.SEED, epoch, r N + w + 1): rank 0
replays the draws of a one-rank run with N workers, and each other rank's
workers take streams no other worker draws.  With 0 workers every rank
draws the dataset's own stream, seeded with cfg.SEED, as each JAX process
does.  Under DATALOADER.BENCHMARK each item's stage times come back with
it and join the consumer's DATALOADER_STAGES (the JAX package's workers
keep theirs, so its report holds only what the consumer made).  Workers
start with DATALOADER.MP_START_METHOD ('auto':
forkserver under a parent with threads, as a torch parent always has),
touch no GPU, and a worker's error, or its death, stops the run with the
error in the consumer.  RHD's loader stays in the calling process (its
draws come from a numpy Generator the workers cannot reseed yet; ROADMAP
P6).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import threading
from typing import Dict, Iterator, List

import numpy as np

from .. import parallel
from ..config import Config, DatasetCatalog
from ..utils.profiling import DATALOADER_STAGES

__all__ = ["ConcatDataset", "EvalLoader", "TrainLoader", "build_dataset", "collate",
           "make_eval_loaders", "make_train_loader", "stop_workers"]

# how long the consumer waits for a batch before it checks that its workers
# are alive
POLL_SECONDS = 5.0


def collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of per-item dicts into batched arrays."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class ConcatDataset:
    """Datasets one after another (the JAX package's ConcatDataset, which
    several DATASETS.TRAIN become): io-bound if any part is."""

    def __init__(self, datasets):
        if not datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])
        self.io_bound = any(getattr(d, "io_bound", False) for d in self.datasets)
        if all(hasattr(d, "reseed") for d in self.datasets):
            self.reseed = self._reseed

    def _reseed(self, seed) -> None:
        for i, d in enumerate(self.datasets):
            d.reseed([*np.atleast_1d(seed), i])

    def __len__(self) -> int:
        return int(self.cum[-1])

    def __getitem__(self, idx: int):
        if idx < 0:
            idx += len(self)
        ds = int(np.searchsorted(self.cum, idx, side="right"))
        return self.datasets[ds][idx - (0 if ds == 0 else int(self.cum[ds - 1]))]


def _start_method(method: str) -> str:
    """'auto' -> forkserver when this process has more than one OS thread
    (a child forked from it could inherit a lock another thread held), else
    fork; other values pass through."""
    if method != "auto":
        return method
    try:
        threads = len(os.listdir("/proc/self/task"))
    except OSError:
        threads = threading.active_count()
    return "forkserver" if threads > 1 else "fork"


def _worker_loop(dataset, seed, tasks, results) -> None:
    """A loader worker: reseed the dataset's draws, then turn (seq, index)
    tasks into (seq, item, None, stage times) until a None task; on an
    error, ship (seq, None, the pickled error, None) and stop.  The stage
    times are what the item added to this process's DATALOADER_STAGES
    (DATALOADER.BENCHMARK), else None; the consumer adds them to its own."""
    dataset.reseed(seed)
    DATALOADER_STAGES.reset()  # a forked worker starts with its parent's
    while True:
        task = tasks.get()
        if task is None:
            return
        seq, idx = task
        try:
            item = dataset[idx]
            results.put((seq, item, None, DATALOADER_STAGES.take()))
        except BaseException as exc:  # noqa: BLE001 - relayed to the consumer
            try:
                payload = pickle.dumps(exc)
                pickle.loads(payload)
            except Exception:
                payload = pickle.dumps(RuntimeError(f"loader worker failed: {exc!r}"))
            results.put((seq, None, payload, None))
            return


def _worker_batches(dataset, batches: List[np.ndarray], num_workers: int, start_method: str,
                    seed: int, epoch: int, first_worker: int = 0
                    ) -> Iterator[Dict[str, np.ndarray]]:
    """`batches` of `dataset` from `num_workers` processes, collated and
    yielded in order.  The epoch's items, in batch order, go round the
    workers (item k to worker k % N), so a batch's items are made in
    parallel; the items of the next two batches are kept in flight.  Worker
    w reseeds the dataset with (seed, epoch, first_worker + w + 1)."""
    order = [int(i) for idx in batches for i in idx]
    ends = np.cumsum([len(idx) for idx in batches]).tolist()
    n = min(num_workers, len(order))
    if n == 0:
        return
    ctx = mp.get_context(_start_method(start_method))
    if ctx.get_start_method() == "forkserver":
        # the server imports the loader and the dataset's module once, and
        # each worker forks from it with them loaded
        ctx.set_forkserver_preload([__name__, type(dataset).__module__])
    tasks = [ctx.Queue() for _ in range(n)]
    results = ctx.Queue()
    workers = [ctx.Process(target=_worker_loop,
                           args=(dataset, [seed, epoch, first_worker + w + 1], tasks[w],
                                 results),
                           daemon=True, name=f"loader-worker-{w}") for w in range(n)]
    for p in workers:
        p.start()
    sent = 0

    def send_upto(limit: int) -> None:
        nonlocal sent
        while sent < min(limit, len(order)):
            tasks[sent % n].put((sent, order[sent]))
            sent += 1

    finished = False
    try:
        ready: Dict[int, tuple] = {}
        start = 0
        for b, end in enumerate(ends):
            send_upto(ends[min(b + 2, len(ends) - 1)])
            while not all(k in ready for k in range(start, end)):
                failed = [k for k in range(start, end) if k in ready and ready[k][1] is not None]
                if failed:  # its worker has stopped: raise it
                    raise pickle.loads(ready[failed[0]][1])
                try:
                    got, item, err, stages = results.get(timeout=POLL_SECONDS)
                except queue.Empty:
                    dead = [p for p in workers if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"loader worker {dead[0].name} (pid {dead[0].pid}) "
                                           f"died with exit code {dead[0].exitcode}") from None
                    continue
                if stages:
                    DATALOADER_STAGES.merge(stages)
                ready[got] = (item, err)
            items = []
            for k in range(start, end):  # an error surfaces in the item order
                item, err = ready.pop(k)
                if err is not None:
                    raise pickle.loads(err)
                items.append(item)
            yield collate(items)
            start = end
        finished = True
    finally:
        # at the end every result has been read, so the workers can exit;
        # after an error, or a consumer that stopped early, they may still
        # be making or shipping items: stop them
        for q in tasks:
            q.put(None)
        for p in workers:
            if not finished:
                p.terminate()
            p.join(timeout=5.0)
        for q in (*tasks, results):
            q.cancel_join_thread()
            q.close()


def stop_workers() -> None:
    """Stop the processes that worker loaders leave running between runs,
    and wait for each to end: workers of a loader whose consumer stopped
    early and was not yet collected, the forkserver they fork from, and
    multiprocessing's resource tracker.  Both of the last two outlive a
    loader and end only some time after their parent, so a program that
    must leave no process behind calls this before it ends, once it holds
    no loader iterator.  A later loader starts them anew."""
    import gc
    from multiprocessing import forkserver, resource_tracker

    # an iterator nothing refers to any more closes its queues, whose
    # semaphores the resource tracker would otherwise unlink under them
    gc.collect()
    for p in mp.active_children():
        if p.name.startswith("loader-worker-"):
            p.terminate()
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
    # multiprocessing has no public call that stops either; `_stop` closes
    # the process's pipe, which ends it, and waits for it
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def _batches(dataset, batches: List[np.ndarray], num_workers: int, start_method: str,
             seed: int, epoch: int, first_worker: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    if num_workers > 0:
        return _worker_batches(dataset, batches, num_workers, start_method, seed, epoch,
                               first_worker)
    return (collate([dataset[int(i)] for i in idx]) for idx in batches)


def num_workers_for(cfg: Config, dataset) -> int:
    """DATALOADER.NUM_WORKERS (at most 4 a core) for an io-bound dataset
    whose draws a worker can reseed; 0 for the others."""
    if not (getattr(dataset, "io_bound", False) and hasattr(dataset, "reseed")):
        return 0
    return min(cfg.DATALOADER.NUM_WORKERS, 4 * (os.cpu_count() or 1))


class EvalLoader:
    """`dataset` in order, in batches of `batch_size` items; the last
    partial batch is kept (the JAX `DataLoader(shuffle=False,
    drop_last=False)`)."""

    def __init__(self, dataset, batch_size: int = 1, num_workers: int = 0,
                 start_method: str = "auto", seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.start_method = start_method
        self.seed = seed

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def index_batches(self) -> List[np.ndarray]:
        n = len(self.dataset)
        return [np.arange(s, min(s + self.batch_size, n)) for s in range(0, n, self.batch_size)]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return _batches(self.dataset, self.index_batches(), self.num_workers, self.start_method,
                        self.seed, 0)


class TrainLoader:
    """Shuffled batches of `batch_size` items; the last partial batch is
    dropped.  Epoch e visits the items in the order
    `np.random.RandomState(seed + e).shuffle(np.arange(n))`, as the JAX
    `DataLoader(shuffle=True, drop_last=True)` does; the epoch counts only
    passes that ran to their end, as there.

    Data parallel: `shard_id` of `num_shards` hosts takes `order[shard_id::
    num_shards]` in batches of `batch_size` (the host's batch, as the JAX
    `DataLoader(shard_id, num_shards)`), and `local_rank` of the host's
    `local_world` ranks yields the local_rank-th contiguous slice of each;
    the rank's workers are numbered from rank * num_workers."""

    def __init__(self, dataset, batch_size: int, seed: int, num_workers: int = 0,
                 start_method: str = "auto", shard_id: int = 0, num_shards: int = 1,
                 local_rank: int = 0, local_world: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_workers = num_workers
        self.start_method = start_method
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.local_rank = local_rank
        self.local_world = local_world
        self.rank_batch = parallel.per_rank_batch(batch_size, local_world)
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.num_shards // self.batch_size

    def indices(self) -> np.ndarray:
        """This epoch's item order over the whole dataset."""
        idx = np.arange(len(self.dataset))
        np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def index_batches(self) -> List[np.ndarray]:
        """This epoch's batches of this rank's items."""
        idx = self.indices()[self.shard_id::self.num_shards]
        lo = self.local_rank * self.rank_batch
        return [idx[b * self.batch_size:(b + 1) * self.batch_size][lo:lo + self.rank_batch]
                for b in range(len(self))]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rank = self.shard_id * self.local_world + self.local_rank
        yield from _batches(self.dataset, self.index_batches(), self.num_workers,
                            self.start_method, self.seed, self.epoch, rank * self.num_workers)
        self.epoch += 1


def build_dataset(cfg: Config, name: str):
    """A DatasetCatalog name (or alias, 'RHD_train'/'RHD_val') -> the port's
    dataset, its draws seeded with cfg.SEED.  Raises on a factory the port
    lacks."""
    entry = DatasetCatalog.get(name)
    factory = entry["factory"]
    is_train = entry["is_train"]
    if factory == "SyntheticMultiview":
        from .datasets.synthetic import SyntheticMultiview

        return SyntheticMultiview(cfg, is_train=is_train, n_samples=entry.get("n_samples", 256),
                                  seed=entry.get("seed", 0))
    if factory == "RHDDataset":
        from .datasets.rhd import RHDDataset

        return RHDDataset(cfg, entry["root"], entry["set"], is_train=is_train, seed=cfg.SEED)
    if factory in ("MultiViewH36M", "H36MDataset"):
        from .datasets import multiview_h36m

        return getattr(multiview_h36m, factory)(cfg, entry["root"], entry["anno"],
                                                is_train=is_train, seed=cfg.SEED)
    if factory in ("MPIIDataset", "MultiviewMPIIDataset"):
        from .datasets import mpii

        return getattr(mpii, factory)(cfg, entry["root"], entry.get("set", "train"),
                                      is_train=is_train, seed=cfg.SEED)
    if factory == "MixedDataset":
        from .datasets.mpii import MixedDataset

        return MixedDataset(build_dataset(cfg, entry["h36m"]), build_dataset(cfg, entry["mpii"]))
    raise NotImplementedError(f"dataset {name!r}: the port has no {factory!r} factory")


def _loader_args(cfg: Config, dataset) -> dict:
    return dict(num_workers=num_workers_for(cfg, dataset),
                start_method=cfg.DATALOADER.MP_START_METHOD)


def make_train_loader(cfg: Config) -> TrainLoader:
    """DATASETS.TRAIN concatenated into one shuffled loader of
    SOLVER.IMS_PER_BATCH items a host that drops the last partial batch
    (JAX `make_data_loader(cfg, is_train=True, shard_id=process_index,
    num_shards=process_count)`); under a process group, this rank's share
    of its host's batches."""
    datasets = [build_dataset(cfg, n) for n in cfg.DATASETS.TRAIN]
    dataset = datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)
    args = _loader_args(cfg, dataset)
    ranks = parallel.local_world()
    if args["num_workers"]:  # DATALOADER.NUM_WORKERS is the host's, as the batch is
        args["num_workers"] = max(1, args["num_workers"] // ranks)
    return TrainLoader(dataset, batch_size=cfg.SOLVER.IMS_PER_BATCH, seed=cfg.SEED,
                       shard_id=parallel.host(), num_shards=parallel.hosts(),
                       local_rank=parallel.local_rank(), local_world=ranks, **args)


def make_eval_loaders(cfg: Config) -> List[EvalLoader]:
    """One loader per DATASETS.TEST, in batches of TEST.IMS_PER_BATCH (JAX
    `make_data_loader(cfg, is_train=False)`)."""
    loaders = []
    for name in cfg.DATASETS.TEST:
        dataset = build_dataset(cfg, name)
        loaders.append(EvalLoader(dataset, cfg.TEST.IMS_PER_BATCH, seed=cfg.SEED,
                                  **_loader_args(cfg, dataset)))
    return loaders
