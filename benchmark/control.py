"""The readings that a cell's limits are set from, on the card:

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

For each seed: the cell's pool, drawn as a run draws it; the program's
outputs through the cell's entry, one request for each input; the plain
reference's outputs; and the control's, the reference with sjpeg's integer
fDCT swapped for a float32 DCT (the configuration's guarantee is sjpeg's
bytes, and a float transform is the step that would tempt a faster
encoder).  Prints one JSON line a seed with the numbers that a run
compares, for the program and for the control, then the lowest and
highest of each over the seeds.  Exits non-zero without a card."""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, device) -> dict:
    from benchmark import harness
    from benchmark.reference import spec
    engine, param, pool, pool_pixels, drive = harness.set_up(cell, seed,
                                                             device)
    win = harness.Window(pool_pixels, count=len(pool), seed=seed)
    drive(engine, param, pool, cell.traffic, win, device)
    settings = harness.reference_settings(cell.config)
    expected, content = harness.reference_jpegs(pool, settings)
    control, _ = harness.reference_jpegs(pool, settings,
                                         fdct=spec.fdct_blocks_float32)
    program, _ = harness.compare(win.sample, expected)
    ctrl, _ = harness.compare({i: (i, control[i]) for i in control},
                              expected)
    return {"seed": seed, "program": {k: v["value"]
                                      for k, v in program.items()},
            "control": {k: v["value"] for k, v in ctrl.items()},
            "jpegs": sum(len(v) for v in expected.values()),
            "content": content}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    os.environ.pop("SJPEG_EXACT_RISKINESS", None)
    sys.path[0] = str(ROOT)

    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("no CUDA device: the control runs on the card only",
              file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        row = readings(cell, seed, torch.device("cuda:0"))
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {side: {k: [min(r[side][k] for r in rows),
                          max(r[side][k] for r in rows)]
                      for k in rows[0][side]}
               for side in ("program", "control")}
    print(json.dumps({"workload": cell.name, "seeds": len(rows),
                      "min_max": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
