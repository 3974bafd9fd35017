"""batch_step_us: device-busy microseconds per step of the batched loop
(one vmapped PDHG iteration of every instance): the union of the device
intervals of ``jit__batched_pdhg_run`` in the traced stretch, over the
loop trips of the traced requests."""

from lib import trace


def read(run):
    return trace.loop_step_us(run) if run.batch > 1 else None
