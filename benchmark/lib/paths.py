"""The two call paths a user takes into prost, with the harness's spans
around the calls into each layer.

``Single``: one image per request, modeling layer -> ``finalize`` ->
``pt.solve`` (Solver -> BackendPDHG).  ``Batch``: a batch of images per
request, each through the modeling layer's ``finalize``, then one
``BatchedPDHG`` solve.  Both return a ``Done`` record per request.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Done:
    answer: np.ndarray   # what the user gets: (H, W) / (L, H, W), batched
    images: int
    iters: list          # iterations of each image's solve
    trips: int           # trips of the solve's loop
    converged: int       # images that met the stopping rule


def _sopts(cfg, max_iters):
    import prost_tpu as pt

    tol = cfg["tolerance"]
    return pt.options(max_iters=int(max_iters), verbose=False,
                      tol_rel_primal=tol, tol_rel_dual=tol,
                      tol_abs_primal=tol, tol_abs_dual=tol)


class Single:
    def __init__(self, builder, cfg):
        import prost_tpu as pt

        self.builder, self.cfg = builder, cfg
        self.backend = pt.backend_pdhg(**cfg["backend"])

    def __call__(self, image, max_iters, span):
        import jax

        import prost_tpu as pt
        from prost_tpu.solver import ConvergenceResult

        with span("build"):
            core = jax.block_until_ready(
                self.builder.build(image, self.cfg).finalize())
        with span("solve"):
            res = pt.solve(core, self.backend, _sopts(self.cfg, max_iters))
        with span("fetch"):
            ans = self.builder.answer(res.x, image.shape, self.cfg)
        ok = res.result == ConvergenceResult.CONVERGED
        return Done(ans, 1, [int(res.iterations)], int(res.iterations),
                    int(ok))


class Batch:
    def __init__(self, builder, cfg):
        from prost_tpu.backend.pdhg import PDHGOptions

        self.builder, self.cfg = builder, cfg
        self.popts = PDHGOptions(**cfg["backend"])

    def __call__(self, images, max_iters, span):
        import jax

        from prost_tpu.parallel import BatchedPDHG

        with span("build"):
            problems = [self.builder.build(im, self.cfg).finalize()
                        for im in images]
            solver = BatchedPDHG(problems, self.popts,
                                 _sopts(self.cfg, max_iters))
            jax.block_until_ready((solver.batched_problem, solver.prox_g,
                                   solver.prox_fstar))
        with span("solve"):
            state = solver.run(solver.initial_state(), max_iters)
            iters = np.asarray(state.iteration)
            conv = np.asarray(state.converged)
        with span("fetch"):
            x = np.asarray(solver.current_solution(state)[0])
            ans = np.stack([self.builder.answer(xb, images.shape[1:],
                                                self.cfg) for xb in x])
        return Done(ans, len(images), [int(i) for i in iters],
                    int(iters.max()), int(conv.sum()))


def for_traffic(traffic, builder, cfg):
    return (Batch if int(traffic.get("batch", 1)) > 1 else Single)(
        builder, cfg)
