"""Share of the profiled sub-window the embedder's drain sat blocked on
the card (its own `device_wait_ms`, differenced)."""
LAYER = "engine/embedder.py"
UNIT = "%"
MOVES = "embeddings_per_s"
SOURCE = "program_span"


def read(ctx):
    if not ctx.edges or "device_wait_ms" not in ctx.edges[0] \
            or ctx.sub_s <= 0:
        return None
    waited = ctx.edges[1]["device_wait_ms"] - ctx.edges[0]["device_wait_ms"]
    return 100.0 * waited / (ctx.sub_s * 1e3)
