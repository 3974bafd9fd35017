"""The control of a cell's correctness check: the plain reference put in
the program's place, computed in bfloat16, the precision below the
configuration's float32.  Its answers must fail the cell's limits.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 \
        [--requests 3] [--iters 3000]

For each seed it answers the cell's first requests with the bfloat16
reference (``--iters`` iterations, about what the program needs) and
prints every number compared beside its limit, as a run of the cell
would.  The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from lib import spec, traffic  # noqa: E402


def readings(cell, seed, requests, iters):
    """{number: worst value} of the bfloat16 control's answers to the
    first ``requests`` requests of ``seed``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    gen = traffic.Traffic(cell.traffic, seed)
    worst = {}
    with jax.enable_x64(True):
        for i in range(requests):
            images = gen.request(i)
            ref = cell.reference.reference(images, cell.config)
            ctl = cell.reference.reference(images, cell.config,
                                           dtype=jnp.bfloat16,
                                           max_iters=iters)
            nums = cell.reference.numbers(ctl["u"].astype(np.float32),
                                          images, cell.config, ref)
            for k, v in nums.items():
                worst[k] = max(worst.get(k, -np.inf), v)
    return worst


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--iters", type=int, default=3000)
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.load(), args.workload)
    failed_all = True
    for seed in args.seeds:
        worst = readings(cell, seed, args.requests, args.iters)
        over = {k: worst[k] > lim for k, lim in cell.limits["limits"].items()}
        failed_all &= any(over.values())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": worst, "limits": cell.limits["limits"],
                          "fails_a_limit": any(over.values())}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
