"""Readings of the compared numbers over many seeds in one process, for
setting the limits of judge.json: the program's own runs; the control,
which breaks one guarantee of the configuration (every Gibbs chain reads a
tenth of the k-mers that the configuration states, judge.json "control");
a cut run (chains of a tenth of the stated iterations, judge.json "cut");
or the program with a fault of faults.py planted. Each seed runs without
the warm-up unit, which only steadies the timing. The benchmark's runs
never run this.

    python3 portbench/readings.py --workload <cell> --seconds <s> \\
        --seeds 1 2 3 [--control | --cut | --fault <name>]

One JSON line per seed: the checks, correct, the units and variants/s.
"""

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import faults, run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--cut", action="store_true")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    program = None
    for flag in ("control", "cut"):
        if getattr(args, flag):
            program = run.load_json(run.HERE, "judge.json")[flag]
    for seed in args.seeds:
        with (faults.FAULTS[args.fault]() if args.fault
              else contextlib.nullcontext()):
            result, checks = run.run_cell(
                args.workload, seed, args.seconds, False, program=program,
                warm=False, log=lambda m: print(m, file=sys.stderr))
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "control": args.control, "cut": args.cut, "fault": args.fault,
            "correct": result["correct"],
            "checks": {n: v for n, v, _ in checks},
            "metrics": {n: m["value"] for n, m in result["metrics"].items()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
