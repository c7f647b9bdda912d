"""The control of the benchmark's correctness check: the plain reference
computed in the precision below the configuration's, put in the program's
place, must come out not correct.

    python3 -m rtbench.control --workload bob-orbit --seeds 11,12,13 --frames 250

The configurations state float32 with no TF32 (the sweep's pair test has no
matrix product), so the control is the reference with every ray/triangle
product's operands rounded to TF32 (``Reference(lowp=True)``). For an orbit
it renders the pixels that a run with the seed and ``--frames`` frames
compares; for a fit it runs the first steps, then the last steps' number
from the float64 reference's state after its first steps. Each seed prints one JSON line:
the numbers of ``rtbench/check.py`` beside the cell's limits, and whether
they pass. The benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from rtbench import check, manifest, workload


def control(name: str, seed: int, frames: int, device="cuda",
            config_overrides: dict | None = None, traffic_overrides: dict | None = None) -> dict:
    """One seed of the control: its numbers beside the cell's limits. The
    overrides are for tests at a small size on the CPU."""
    man = manifest.load()
    cell = manifest.cell(man, name)
    config = dict(manifest.config(man, cell), **(config_overrides or {}))
    mix = dict(manifest.traffic(cell["traffic"]), **(traffic_overrides or {}))
    torch.backends.cuda.matmul.allow_tf32 = False
    loop = workload.KINDS[mix["kind"]](config, mix, seed, device)
    loop.plan()
    t0 = time.time()
    if mix["kind"] == "fit":
        ref = loop.reference_fit()
        low = loop.reference_fit(lowp=True, start=ref["first"]["end"])
        numbers = workload.fit_check(low, ref)
    else:
        sample = loop.checked(frames)
        numbers = check.frame_numbers(loop.reference_pixels(sample, lowp=True).reshape(-1, 3),
                                      loop.reference_pixels(sample).reshape(-1, 3))
    correct, checks = check.judge(numbers, manifest.limits(name))
    return {"cell": name, "seed": seed, "frames": frames if mix["kind"] != "fit" else None,
            "correct": correct, "checks": checks, "seconds": time.time() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--frames", type=int, default=250, help="orbit frames a run compares")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("rtbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        print(json.dumps(control(args.workload, int(s), args.frames)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
