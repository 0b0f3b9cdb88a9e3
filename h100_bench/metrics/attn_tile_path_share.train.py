"""The share of the attention's query tiles, forward and backward, that the
tile kernels took (the rest took the per-query kernels), over the traced
part: the port's tile counts, summed once when its spans are drained."""

from h100_bench.harness import port_spans

LAYER, UNIT, MOVES, SOURCE = "Attention kernels", "%", "train_samples_per_s", "program_span"

TILE = ("attn.forward_tiles.tile_path", "attn.backward_tiles.tile_path")
PER_QUERY = ("attn.forward_tiles.per_query_path", "attn.backward_tiles.per_query_path")


def read(run):
    p = port_spans.of(run) if run.kind == "train" else None
    if p is None:
        return None
    tile = sum(p.total(c) for c in TILE)
    every = tile + sum(p.total(c) for c in PER_QUERY)
    return 100.0 * tile / every if every else None
