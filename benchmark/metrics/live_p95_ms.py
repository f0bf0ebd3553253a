"""The 95th percentile, over every round of the window, of the time from
handing a round's chunks to the session (``dispatch``) to holding every
station's events (``collect``), host clock."""

import numpy as np


def read(ctx):
    lat = ctx.window.get("latencies")
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
