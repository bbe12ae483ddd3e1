"""Process start to the first timed invocation (host clock): imports,
CUDA start, the inputs, the warm invocation (which builds the plan
libraries in a fresh checkout, and loads them from build/cuda/ after)."""


def read(ctx):
    return ctx.setup_s
