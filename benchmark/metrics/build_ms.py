"""build_ms: host milliseconds per image from the observation array to the
finalized, device-resident problem: the modeling layer, ``finalize`` and
its preconditioners, and for a batch the stacking, divided by the batch.
Read from the harness's "build" spans over the window's untraced
requests."""


def read(run):
    recs = [r for r in run.requests if not r["traced"]]
    if not recs:
        return None
    return 1e3 * sum(r["build_s"] for r in recs) / (len(recs) * run.batch)
