"""The correctness check's readings on the card: for each seed, one run of
a cell with the program (its compared numbers: the lower reading), and
the same served tokens or sequences held by the reference in a lower
precision, put in the program's place (the control), through the same
limits and the same rule as the program. With ``--fault``, the program
runs with that fault planted (``faults.py``) and should come out not
correct.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 --seconds 30 \\
        [--controls bf16,tf32] [--fault one_request]

The benchmark's own runs never run the controls or the faults. Prints one
JSON line a seed: the program's ``correct`` and numbers, and each
control's.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from .run import _cache_dirs  # noqa: E402


def planted(fault: str, workload: str, seed: int):
    """The context that plants ``fault`` for a run of ``workload``."""
    from . import faults
    from . import traffic as gen
    from .harness import load_cell

    if not fault:
        return contextlib.nullcontext()
    _, _, config, traffic, _, _, _ = load_cell(workload)
    if fault == "one_request":
        longest = max(gen.lengths(traffic["prompt_len"], traffic["queue"], seed))
        return faults.one_request(longest, traffic["batcher"]["max_new_tokens"] // 2,
                                  config["model"]["vocab_size"])
    raise ValueError(f"no fault {fault!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", default="bf16,tf32")
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)
    _cache_dirs()

    import torch

    from .harness import clock, run_cell

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    controls = [c for c in args.controls.split(",") if c]
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        with planted(args.fault, args.workload, seed):
            result = run_cell(args.workload, seed, args.seconds, False,
                              torch.device("cuda", 0), T_START if k == 0 else clock(),
                              controls=controls, log=lambda *a: print(*a, file=sys.stderr))
        line = {"seed": seed, "fault": args.fault or None, "correct": result["correct"],
                "checks": result["checks"], "readings": result.get("readings", {}),
                "controls": result.get("controls", {}),
                "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                "memory_peak_bytes": result["device"]["memory_peak_bytes"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
