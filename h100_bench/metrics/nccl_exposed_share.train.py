"""The share of the traced part in which the device ran an NCCL kernel and
nothing else: what the step waits on the other ranks' collectives, in %.
`device_idle_share.train` counts an NCCL kernel that spins on its peers as
busy; this counts the part of it that no other kernel, copy or fill
overlaps.  None where the traced part ran no NCCL kernel (one rank)."""

LAYER, UNIT, MOVES, SOURCE = "Collectives (NCCL)", "%", "train_samples_per_s", "device_trace"


def _union(intervals, start, end):
    """The union of (t0, t1, name) intervals clipped to [start, end], merged."""
    out = []
    for t0, t1, _ in sorted(intervals):
        t0, t1 = max(t0, start), min(t1, end)
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    t = run.trace
    nccl = _union([d for d in t.device if "nccl" in d[2].lower()], t.start, t.end)
    if not nccl:
        return None
    other = _union([d for d in t.device if "nccl" not in d[2].lower()], t.start, t.end)
    exposed, j = 0.0, 0
    for a, b in nccl:  # each NCCL stretch less the other work inside it
        exposed += b - a
        while j < len(other) and other[j][1] <= a:
            j += 1
        k = j
        while k < len(other) and other[k][0] < b:
            exposed -= min(b, other[k][1]) - max(a, other[k][0])
            k += 1
    return 100.0 * exposed / t.window_s
