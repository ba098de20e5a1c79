"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), device, with --trace 1 breakdown, and
last the checks, each number compared beside its limit; the checks are also
the last lines of standard error.  Exits non-zero without a result when no
card is there, when the card count is short of the cell's, when the port
is missing, or when JAX or the JAX package is loaded once the window has
closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the port builds its kernel libraries once into sjpeg_tpu_torch/_build,
    # inside the checkout; YUV_AUTO runs the port's default scorer, which
    # the reference holds to sjpeg's own table
    os.environ.pop("SJPEG_EXACT_RISKINESS", None)
    # the checkout's root, not this folder, heads the import path
    sys.path[0] = str(ROOT)

    import torch
    from benchmark import harness

    try:
        cell = harness.load_cell(args.workload)
        if not torch.cuda.is_available():
            raise harness.Failure("no CUDA device: the benchmark runs on "
                                  "the card only")
        if torch.cuda.device_count() < cell.chips:
            raise harness.Failure(f"{cell.name} needs {cell.chips} cards, "
                                  f"{torch.cuda.device_count()} found")
        try:
            import sjpeg_tpu_torch  # noqa: F401
        except ImportError as exc:
            raise harness.Failure(f"the port does not import: {exc}")
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda:0", T_START)
    except harness.Failure as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
