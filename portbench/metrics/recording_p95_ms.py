"""95th percentile over all the window's calls of each call's time from
its start to its output being ready, on the device's clock: CUDA events on
a stream idle before each call (each call is synchronized before the next)."""
from portbench.readers import event_p95_ms


def read(ctx):
    return event_p95_ms(ctx, "call")
