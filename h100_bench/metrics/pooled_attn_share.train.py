"""The share of the traced part's device busy time that lies inside the
pooled attention's brackets (its forward and its backward, between the
port's device marks: harness/brackets.py), in %.  None for a program that
has no such marks; a traced part of a program that has them but left no
bracket there is an error, not a reading."""

from h100_bench.harness import brackets

LAYER, UNIT, MOVES, SOURCE = "Pooled attention (plain)", "%", "train_samples_per_s", \
    "device_trace"


def read(run):
    if run.kind != "train" or run.trace is None or not brackets.program_marks():
        return None
    found = brackets.brackets(run.trace)
    if not found["forward"] or not found["backward"]:
        raise RuntimeError(f"no whole bracket of each phase of {brackets.MARKS} in the "
                           "traced part: renamed, or taken off the path?")
    inside = brackets.busy_inside(run.trace, sorted(found["forward"] + found["backward"]))
    return 100.0 * inside / run.trace.busy_s()
