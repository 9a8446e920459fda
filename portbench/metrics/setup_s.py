"""Set-up: from the process's start to the first timed solve (imports,
the operator, the pool of right-hand sides, ``decompose``, ``RASolver``
with its eigensolves, factors and copies to the card, the warm-up
solves; on a checkout's first run also the build of the kernels)."""


def read(ctx):
    return ctx.setup_s
