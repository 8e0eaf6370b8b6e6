"""Run a cell with a fault planted in its timed path, on the card, and
print what the correctness check compared, one JSON line a seed.

    python3 porla_bench/control.py --workload ipa-n1024.update \\
        --fault stale_update --seeds 11,12,13 --seconds 10

`--root` names the directory that holds the `BENCHMARK.json` and the
benchmark's data files to run (by default the checkout's own).

The control of the benchmark's check: each fault of `porla_bench.faults`
breaks a guarantee the configurations state, so every line must read
`correct` false with some number over its limit. `--fault none` runs the
program as it is. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    from porla_bench import faults, harness, manifest

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True,
                    choices=("none",) + faults.FAULTS)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--root", default=manifest.ROOT)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        fault = None if args.fault == "none" else args.fault
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             device="cuda", root=args.root, fault=fault)
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"],
                          "checks": {k: c["value"]
                                     for k, c in r["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
