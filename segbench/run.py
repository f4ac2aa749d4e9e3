"""Run one cell of the benchmark once, on the machine it is started on.

    python3 segbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the numbers compared with the reference, each beside its limit, as
the last lines of standard error, and one JSON line as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.

Exits non-zero and prints no result when there is no CUDA device or fewer
than the cell asks for, when segtpu_torch cannot be imported, or when the
process holds a module of JAX or of segtpu once the run is over.
"""

import time

# set-up is timed from here: the interpreter's own start, before this line,
# is left out
_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from segbench import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True, help="the window's length")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    chips = harness.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"segbench: {args.workload} needs {chips} CUDA device(s); {found} found",
              file=sys.stderr)
        return 2
    import segtpu_torch  # noqa: F401  the system under test; without it no run

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), origin=_T0)
    found = harness.forbidden_modules()
    if found:
        print(f"segbench: the process holds JAX or segtpu modules: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
