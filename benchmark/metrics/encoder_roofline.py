"""The least time the chip could take for the encoder work committed in
the profiled sub-window (its FLOPs over the bf16 peak, or its batches'
weight bytes over HBM bandwidth, whichever is larger) over the device's
busy time there.  The process runs nothing on the card but the encoder,
so this reads the same work whatever kernel implements it."""
from benchmark.harness import peaks

LAYER = "encoder kernels"
UNIT = "%"
MOVES = "embeddings_per_s"
SOURCE = "device_trace"


def read(ctx):
    prof = ctx.profile
    if prof is None or prof["busy_s"] <= 0 or not ctx.done:
        return None
    cfg, counter = ctx.cell.config, ctx.cell.counter
    flops = counter.flops(cfg, [r[4] for r in ctx.done])
    batches = ctx.edges[1]["batches"] - ctx.edges[0]["batches"]
    bound_s = max(flops / peaks.BF16_FLOPS,
                  batches * counter.weight_bytes(cfg) / peaks.HBM_BYTES_PER_S)
    return 100.0 * bound_s / prof["busy_s"]
