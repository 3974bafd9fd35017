"""pdhg_iter_roofline: percent of the HBM roofline that one PDHG iteration
of ROF reaches.  The least time an iteration can take is the bytes it must
move in one pass over the state, over the published HBM bandwidth; the
time it takes is the device-busy time per iteration of the solve loop
(iter_us, or batch_step_us on the batched path).

Bytes per pixel of one iteration, counted from the problem's shapes and not
from what XLA launches: read x, y (2 floats), Kx (2), K^T y, the data f and
the preconditioners Sigma (2) and Tau; write x, y (2), Kx (2) and K^T y:
16 float32 = 64 bytes.  A kernel that keeps state on chip across
iterations needs this count redefined before it can read over 100%."""

from lib import trace

FLOATS_PER_PIXEL = 16
BYTES_PER_FLOAT = 4


def iter_bytes(shape, batch=1):
    """Bytes one ROF PDHG iteration must move for ``batch`` images of
    ``shape``."""
    rows, cols = shape
    return FLOATS_PER_PIXEL * BYTES_PER_FLOAT * rows * cols * batch


def read(run):
    if run.peaks is None:
        return None
    us = trace.loop_step_us(run)
    if not us:
        return None
    least_s = iter_bytes(run.shape, run.batch) / run.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (us * 1e-6)
