"""Builder for the ``multilabel`` configuration: the fast multilabel
relaxation of example_multilabel_fast.m through prost's modeling layer,

    min_{u >= 0} max_{q, s}  <u, c> + <grad u, q> - I(||q_px|| <= lmb)
                             + <sum_l u_l, s> - <s, 1>

with quadratic unaries c against ``labels`` evenly spaced grey levels.
"""

import numpy as np


def unaries(image, labels):
    """(L, H, W) float32 unaries of an (H, W) grey image, label-outermost
    as gradient2d's label_first=False layout wants them."""
    means = np.linspace(0.0, 1.0, labels, dtype=np.float32)
    return (image[None] - means[:, None, None]) ** 2


def build(image, cfg):
    import prost_tpu as pt
    from prost_tpu import block, function

    L, lmb = cfg["labels"], cfg["lmb"]
    nx, ny = image.shape
    n = nx * ny
    c = unaries(np.asarray(image, np.float32), L).reshape(-1)
    u = pt.Variable(n * L)
    q = pt.Variable(2 * n * L)
    s = pt.Variable(n)
    prob = pt.MinMaxProblem([u], [q, s])
    prob.add_function(u, function.sum_1d("ind_geq0", 1, 0, 1, c, 0))
    prob.add_function(q, function.sum_norm2(2 * L, False, "ind_leq0",
                                            1 / lmb, 1, 1))
    prob.add_function(s, function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, block.sparse_kron_id(np.ones((1, L)), n))
    return prob


def answer(x, image_shape, cfg):
    """The label assignment u as (L, H, W)."""
    return np.asarray(x, np.float32)[: cfg["labels"] * image_shape[0]
                                     * image_shape[1]].reshape(
        (cfg["labels"],) + tuple(image_shape))
