"""The epipolar attention's backward against its roofline: the least seconds of
the traced window's backward calls (harness/work.py, on the reference's sample
locations, at the published peak of the dtype the kernel is handed) over
the device seconds of the kernels named below.  A window whose calls
run none of them is an error, not a reading."""

LAYER, UNIT, MOVES, SOURCE = "Attention kernels", "%", "train_samples_per_s", "device_trace"

# the port's attention kernels (csrc/epipolar_attention.cu), by phase;
# group_kernel sorts the queries for both and counts for the phase after it
FORWARD = ("tile_forward_kernel", "epipolar_attention_kernel")
BACKWARD = ("tile_backward_kernel", "tile_reduce_kernel", "query_backward_kernel",
            "tile_histogram_kernel", "tile_scan_kernel", "row_offset_kernel", "fill_kernel",
            "row_gather_kernel", "row_fixup_kernel")
SHARED = ("group_kernel",)


def read(run):
    if run.kind != "train" or run.trace is None or not run.attention_bound_s.get("backward"):
        return None
    device_s = run.trace.phase_times(FORWARD, BACKWARD, SHARED)["backward"]
    if device_s <= 0.0:
        raise RuntimeError(f"none of the backward kernels {BACKWARD + SHARED} ran in the "
                           "traced window: renamed or taken off the path?")
    return 100.0 * run.attention_bound_s["backward"] / device_s
