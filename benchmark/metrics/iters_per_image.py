"""iters_per_image: mean PDHG iterations to the stopping rule per image,
over the window's requests, on the one-image path (``pt.solve``)."""


def read(run):
    if run.batch != 1 or not run.done:
        return None
    iters = [n for d in run.done.values() for n in d.iters]
    return sum(iters) / len(iters)
