"""Rows the embedder commits per encode batch over the profiled
sub-window: its own counters `embedded` / `batches`, differenced."""
LAYER = "engine/embedder.py"
UNIT = "rows"
MOVES = "embeddings_per_s"
SOURCE = "program_counter"


def read(ctx):
    if not ctx.edges or "batches" not in ctx.edges[0]:
        return None
    e0, e1 = ctx.edges[0], ctx.edges[1]
    if e1["batches"] <= e0["batches"]:
        return None
    return (e1["embedded"] - e0["embedded"]) / (e1["batches"] - e0["batches"])
