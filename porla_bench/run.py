"""Run one cell of the benchmark once and print its result line.

    python3 porla_bench/run.py --workload ipa-n1024.update --seed 7 \\
        --seconds 10 --trace 0

Runs on the card and nowhere else: without CUDA, or with fewer cards than
the cell asks for, it exits with 2 and prints no result. The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` also `breakdown`; then `errors` (the
first failed ops, if any), `phases_s` (the seconds of set-up, its parts,
the window, the trace's reading and the check), `card` (the card's name
and power limit) and, last, `checks` (each number the correctness check
compared, beside its limit). The checks are also the last lines of
standard error. A run that
finds JAX or the JAX package loaded once the window has closed exits with
3 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FORBIDDEN = ("jax", "jaxlib", "flax", "porla_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The modules (by default the loaded ones) whose top-level name,
    before the first dot, is JAX's or the JAX package's."""
    return sorted({m for m in (sys.modules if modules is None else modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from porla_bench import harness, manifest

    chips = manifest.cell(manifest.load(), args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA device(s); torch finds {found}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["card"] = card_line()
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
