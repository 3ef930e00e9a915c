"""Readings of the program and of the control of `correct` on a few seeds:
the control is the plain reference put in the program's place (the cell's
kind's `control`) and computed in the nearest precision below the one the
configuration states (float32 with TF32 off -> TF32; uint8 -> 4-bit),
driven through the same loop and judged by the same comparison, which it
has to fail.

    python3 -m benchmark.lib.control --workload <cell> --seeds 1,2,3 [--seconds 6]

from the root of a checkout on a machine with a CUDA device prints, for
each seed, the program's numbers and then the control's (one JSON line
each).  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import runner

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Readings of the program and of the control.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    parts = runner.cell(runner.load_manifest(), args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        for side in ("program", "control"):
            entries = (None if side == "program"
                       else parts["kind"].control(runner.lowered(parts["config"])))
            res, numbers, _ = runner.run_cell(args.workload, seed, args.seconds, False, "cuda",
                                              entries=entries, settle=0)
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "correct": res["correct"], "numbers": numbers,
                              "attempted": res["attempted"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
