"""A cell over several ranks (harness/ranks.py, harness/rank_train.py), on
two gloo ranks on the CPU at a tiny size: one result, rank 0's, correct
against the reference on the global batch; a rank that fails ends the run
at once; every rank runs the step count that rank 0 fixed; the faults a
data-parallel cell can have each come out not correct; `mfu.train`
divides by every card's peak; and the readers of the collectives layer."""

import functools
import json
import time

import pytest

from h100_bench import control
from h100_bench.harness import compare, inputs, rank_train, ranks, spec, train
from h100_bench.harness.record import RunRecord
from h100_bench.harness.trace import Trace
from h100_bench.tests.bench_tiny import tiny_cell
from h100_bench.tests.test_h100_bench_faults import half_batch, unchanged_state

CELL = "r152_384_ddp4.train_b32"
CONFIG = "epipolar_r152_384_ddp4_f32"
SEED = 2 ** 31 + 29
REAL_TRAIN_STEP = rank_train.make_train_step


def _cell():
    """The four-card cell (its configuration and limits files; BENCHMARK.json
    holds no entry for it yet) at a CPU test's size: R-18, global batch 4,
    2 a rank."""
    cell = tiny_cell("r152_384.train_b8", body="epipolarposeR-18")
    config = json.loads((spec.BENCH_DIR / "configs" / f"{CONFIG}.json").read_text())
    assert config["recipe"]["SOLVER"]["IMS_PER_BATCH"] == 32 and config["ranks"] == 4
    cell.name, cell.chips = CELL, config["ranks"]
    cell.limits = json.loads((spec.BENCH_DIR / "limits" / f"{CELL}.json").read_text())
    cell.config["recipe"]["SOLVER"]["IMS_PER_BATCH"] = 4
    return cell


def _launch(target=ranks.rank_main, seconds=0.5):
    return ranks.launch(_cell(), SEED, seconds, False, time.perf_counter(), world=2,
                        backend="gloo", target=target)


def test_two_gloo_ranks_give_one_correct_result(capfd):
    result = _launch()
    assert result is not None and result["correct"] is True, result
    assert result["device"]["count"] == 2 and result["attempted"] >= 1
    assert result["checks"]["rank_gap"]["value"] == 0.0
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}  # no peak on the CPU
    out = capfd.readouterr().out
    for line in out.splitlines():  # no rank printed a result line
        with pytest.raises(ValueError):
            json.loads(line)


def _raising_rank(rank, *args):
    def step_that_fails(cfg, model, optimizer):
        step, calls = REAL_TRAIN_STEP(cfg, model, optimizer), [0]

        def broken(batch):
            calls[0] += 1
            if calls[0] == 5:
                raise RuntimeError("a rank fails in its fifth step")
            return step(batch)

        return broken

    if rank == 1:
        rank_train.make_train_step = step_that_fails
    ranks.rank_main(rank, *args)


def test_a_rank_that_fails_ends_the_run():
    t0 = time.perf_counter()
    assert _launch(_raising_rank) is None
    assert time.perf_counter() - t0 < 120


def _pace_rank(rank, world, port, backend, cell, seed, seconds, trace, t_start, conn):
    """Joins the group and agrees on a count from its own (different) pace."""
    import os

    import torch.distributed as dist

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=world)
    steps = rank_train.agreed_steps(0.1 * (rank + 1), seconds, "cpu")
    dist.destroy_process_group()
    conn.send({"rank": rank, "steps": steps, "result": {"steps": steps} if rank == 0 else None})


def _unequal_rank(rank, world, port, backend, cell, seed, seconds, trace, t_start, conn):
    conn.send({"rank": rank, "steps": rank + 1, "result": {} if rank == 0 else None})


def test_every_rank_runs_rank_0s_step_count():
    assert _launch(_pace_rank, seconds=1.0) == {"steps": 10}  # rank 1 alone would run 5
    assert _launch(_unequal_rank) is None  # the launcher refuses counts that differ


def _second_step_skipped(cfg, model, optimizer):
    """The second step's update undone on this rank: its copy falls behind."""
    step, calls = REAL_TRAIN_STEP(cfg, model, optimizer), [0]

    def broken(batch):
        calls[0] += 1
        saved = {k: v.clone() for k, v in model.state_dict().items()}
        out = step(batch)
        if calls[0] == 2:
            model.load_state_dict(saved)
        return out

    return broken


def _faulty_rank(fault, rank, *args):
    from epipolar_transformers_tpu_torch import parallel

    if fault == "bn_moments_not_exchanged":  # each rank's BN on its own rows
        parallel.all_sum_differentiable = lambda t: t
    elif fault == "gradients_not_exchanged":  # no DistributedDataParallel
        rank_train.data_parallel = lambda cfg, model, device: model
    elif fault == "unchanged_state":
        rank_train.make_train_step = unchanged_state
    elif fault == "half_batch":
        rank_train.make_train_step = half_batch
    elif fault == "a_rank_skips_a_step" and rank == 1:
        rank_train.make_train_step = _second_step_skipped
    ranks.rank_main(rank, *args)


@pytest.mark.parametrize("fault", ["bn_moments_not_exchanged", "gradients_not_exchanged",
                                   "unchanged_state", "half_batch", "a_rank_skips_a_step"])
def test_a_broken_data_parallel_step_is_not_correct(fault):
    result = _launch(functools.partial(_faulty_rank, fault))
    assert result is not None and result["correct"] is False, result


def test_the_control_and_faults_fail_a_limit():
    """At a CPU test's size: the reference with each BN on its rank's rows,
    and a rank whose step is skipped, each fail a limit of the cell."""
    cell = _cell()
    state = train.reference_state(cell, SEED, "cpu")
    rig = inputs.Rig(cell.traffic, cell.recipe, SEED, "cpu")
    batches = inputs.train_batches(rig, 4, cell.traffic["batches"])[:3]
    lr = float(cell.recipe["SOLVER"]["BASE_LR"])
    ref = compare.reference_steps(cell, state, batches, "cpu", "float32", lr)
    local = control.local_moment_steps(cell, state, batches, "cpu", lr, ranks=2)
    assert not compare.all_within(compare.judge(
        {**compare.train_numbers(local, ref), "rank_gap": 0.0}, cell.limits))
    assert control.skipped_step_gap(cell, state, batches, "cpu", lr) > \
        cell.limits["rank_gap"]["limit"]


def _record(cards=1, kernels=(), device=(), steps=2):
    trace = Trace(device=sorted(device), spans=[], start=10.0, end=12.0,
                  kernels=sorted(kernels))
    return RunRecord(kind="train", setup_s=1.0, window_s=2.0, steps=steps, items_per_step=32,
                     peak_window_bytes=1, forward_flops_per_item=1e12, peak_flops=495e12,
                     trace=trace, traced_steps=steps, untraced_steps=10, untraced_s=5.0,
                     cards=cards)


def test_mfu_divides_by_every_cards_peak():
    mfu = spec.reader("mfu.train")
    one, four = mfu.read(_record(1)), mfu.read(_record(4))
    assert one > 0 and four == pytest.approx(one / 4)


def test_the_collectives_readers():
    nccl = [(10.0, 10.5, "ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)"),
            (11.0, 11.4, "ncclKernel_AllReduce_RING_LL_Sum_float(y)"),
            (11.9, 12.5, "ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)")]  # ends past the window
    other = [(10.2, 10.4, "cudnn_conv"), (10.3, 10.6, "Memcpy DtoD"), (11.0, 11.1, "relu")]
    run = _record(kernels=nccl + other[::2], device=nccl + other)
    # exposed: 10.0-10.2 and 11.1-11.4 and 11.9-12.0 = 0.6 s of the 2 s window
    assert spec.reader("nccl_exposed_share.train").read(run) == pytest.approx(30.0)
    assert spec.reader("collectives_per_step.train").read(run) == pytest.approx(1.5)
    alone = _record(kernels=other[::2], device=other)  # one rank: no collective ran
    assert spec.reader("nccl_exposed_share.train").read(alone) is None
    assert spec.reader("collectives_per_step.train").read(alone) is None
    untraced = _record()
    untraced.trace = None
    assert spec.reader("nccl_exposed_share.train").read(untraced) is None

