"""Seconds from the process's start to the window's first call: imports,
the kernels' build or load, the archive made from the seed, the job's
set-up (an extract compresses its archive once) and one warm call."""


def read(ctx):
    return ctx.setup_s
