"""Model FLOPs of the requests committed in the profiled sub-window, at
their real token lengths, over its length and the chip's bf16 peak."""
from benchmark.harness import peaks

LAYER = "models/encoder.py"
UNIT = "%"
MOVES = "embeddings_per_s"
SOURCE = "host_clock"


def read(ctx):
    if not ctx.done or ctx.sub_s <= 0:
        return None
    flops = ctx.cell.counter.flops(ctx.cell.config, [r[4] for r in ctx.done])
    return 100.0 * flops / (ctx.sub_s * peaks.BF16_FLOPS)
