"""setup_s: process start to the first timed call (imports, the CUDA
context, the kernels' build or load, the inputs, the warm-up calls)."""


def read(ctx):
    return ctx.setup_s
