"""iters_per_batch: mean trips of the batched loop until every instance of
the batch met the stopping rule, over the window's requests, on the
batched path (``BatchedPDHG``)."""


def read(run):
    if run.batch == 1 or not run.done:
        return None
    trips = [d.trips for d in run.done.values()]
    return sum(trips) / len(trips)
