"""The control of the check that decides ``correct``: the program run one
precision below what the configuration states (``dtype`` float32 for its
float64, the lower-precision path the program has of its own), at the
cell's own size and load, on several seeds in one process.  Its check has
to come out not correct: the smallest worst residual it reads is the
upper reading of the limit (``PERF.md``).  The benchmark's own runs never
run it.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 10

(from the root of the checkout)
"""

from __future__ import annotations

import argparse
import json
import sys

import portbench

if __name__ == "__main__":
    portbench.steady_process()

from portbench import run  # noqa: E402

LOWER = {"dtype": "float32", "local_compute_dtype": "float32"}


def control(workload: str, seed: int, seconds: float, root: str = run.ROOT,
            device=None) -> dict:
    """One control run: the cell with the configuration's precision
    lowered; returns the run's result line object."""
    return run.run_cell(workload, seed, seconds, False, root=root,
                        device=device, settings_override=LOWER)["result"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run.cache_dirs(run.ROOT)
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        res = control(args.workload, seed, args.seconds)
        c = res["checks"]["rel_residual_max"]
        failed_all &= not res["correct"]
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "rel_residual_max": run._plain(c["value"]),
                          "limit": c["limit"]}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
