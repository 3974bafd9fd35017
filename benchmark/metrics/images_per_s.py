"""images_per_s: images solved in the window, over the time from the
window's start to the end of its last request (the request that straddles
the end is finished and counted)."""


def read(run):
    if not run.requests:
        return None
    elapsed = max(r["end"] for r in run.requests)
    images = sum(d.images for d in run.done.values())
    return images / elapsed if elapsed > 0 else None
