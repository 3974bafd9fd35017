"""Builder for the ``rof`` configuration: ROF (TV-L2) denoising of one
noisy grey image through prost's modeling layer, as
example_rof_primaldual.m writes it:

    min_u max_q  lmb/2 ||u - f||^2 + <grad u, q> - I(||q_px|| <= 1)
"""

import numpy as np


def build(image, cfg):
    """The modeling problem for an (H, W) float32 observation."""
    import prost_tpu as pt
    from prost_tpu import block, function

    nx, ny = image.shape
    n = nx * ny
    u = pt.Variable(n)
    q = pt.Variable(2 * n)
    prob = pt.MinMaxProblem([u], [q])
    prob.add_function(u, function.sum_1d("square", 1, image.reshape(-1),
                                         cfg["lmb"]))
    prob.add_function(q, function.conjugate(
        function.sum_norm2(2, False, "abs")))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, 1))
    return prob


def answer(x, image_shape, cfg):
    """The primal solution vector as an (H, W) image."""
    return np.asarray(x, np.float32).reshape(image_shape)
