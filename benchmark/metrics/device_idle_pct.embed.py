"""Share of the profiled sub-window in which no operation ran on the
card, while the embedder served (the raw trace's device intervals)."""
LAYER = "device"
UNIT = "%"
MOVES = "embeddings_per_s"
SOURCE = "device_trace"


def read(ctx):
    prof = ctx.profile
    if prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
