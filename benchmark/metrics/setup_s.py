"""Process start to the first timed call: imports, the CUDA context, the
kernel library (built on a checkout's first run), the bank, the traffic
made from the seed and the warm-up of the cell's shapes."""


def read(ctx):
    return ctx.setup_s
