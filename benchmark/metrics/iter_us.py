"""iter_us: device-busy microseconds per PDHG iteration on the one-image
path: the union of the device intervals of the solve loop's program
(``jit__pdhg_run``) in the traced stretch, over the iterations the traced
requests ran.  Work outside the loop (normest, finalize, copy-back) does
not count."""

from lib import trace


def read(run):
    return trace.loop_step_us(run) if run.batch == 1 else None
