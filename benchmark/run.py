"""The benchmark of threestudio_3dgs_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the compared numbers beside their
limits as the last lines of standard error and one JSON object as the last
line of standard output: with ``--trace 0`` the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, the device's busy and window
seconds and the breakdown.  Exits non-zero, printing no result, without
the CUDA devices the cell needs, without the program in the checkout, or
when JAX, Flax or the JAX package is loaded once the window has closed.

``--control`` (not a benchmark run) puts the reference, computed one
precision below the configuration's, in the program's place: the numbers
it prints are the control's readings.  ``--fault <name>`` (not a benchmark
run either) plants one of ``faults.py``'s faults in the timed path."""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", default=None, help="plant a fault of faults.py (checks)")
    args = parser.parse_args(argv)
    root = os.getcwd()
    sys.path.insert(0, root)
    from benchmark import faults, harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), root=root,
                             control=args.control, t_process=T_PROCESS,
                             fault=faults.FAULTS[args.fault] if args.fault else None)
    except (harness.CardMissing, FileNotFoundError) as e:
        print(f"[bench] {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"[bench] modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    compared = result.pop("compared")
    result["compared"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in compared.items()}
    for name, c in compared.items():
        print(f"[bench] compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
