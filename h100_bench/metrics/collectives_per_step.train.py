"""NCCL kernels that started in the traced part, per train step: the
collectives of rank 0's step (BatchNorm's all-reduces of the global
moments, forward and backward, and DistributedDataParallel's gradient
buckets).  None where the traced part ran no NCCL kernel (one rank)."""

LAYER, UNIT, MOVES, SOURCE = ("Collectives (NCCL)", "collectives", "train_samples_per_s",
                              "device_trace")


def read(run):
    if run.kind != "train" or run.trace is None or not run.traced_steps:
        return None
    t = run.trace
    n = sum(1 for t0, _, name in t.kernels if t.start <= t0 < t.end and "nccl" in name.lower())
    return n / run.traced_steps if n else None
