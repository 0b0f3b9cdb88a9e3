"""The pooled attention against its roofline: the least seconds of a call
(the cell's reference module's `attention_bound`, forward and backward, on
the reference's sample locations, averaged over the traced part's calls)
times the whole brackets of each phase in the traced part, over the device
busy time inside those brackets (harness/brackets.py), in %.  None for a
program that has no such marks; a traced part of a program that has them
but left no bracket there is an error, not a reading."""

from h100_bench.harness import brackets

LAYER, UNIT, MOVES, SOURCE = "Pooled attention (plain)", "%", "train_samples_per_s", \
    "device_trace"


def read(run):
    bound = run.attention_bound_s
    if run.kind != "train" or run.trace is None or not run.traced_steps or \
            not bound.get("backward") or not brackets.program_marks():
        return None
    found = brackets.brackets(run.trace)
    if not found["forward"] or not found["backward"]:
        raise RuntimeError(f"no whole bracket of each phase of {brackets.MARKS} in the "
                           "traced part: renamed, or taken off the path?")
    least = sum(bound[phase] / run.traced_steps * len(found[phase]) for phase in found)
    inside = brackets.busy_inside(run.trace, sorted(found["forward"] + found["backward"]))
    return 100.0 * least / inside
