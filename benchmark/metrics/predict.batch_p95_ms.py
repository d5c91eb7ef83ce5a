"""95th percentile of the traced batches' latencies, in ms: each from the
call into the device program to its last CUDA-event mark ("mask tail",
where its outputs are complete), over every batch of the traced window."""

import numpy as np


def read(ctx):
    lat = ctx.get("latencies")
    return float(np.percentile(lat, 95)) if lat else None
