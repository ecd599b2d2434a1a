"""Host dispatch of the model step: kernels the device ran a decode step,
counted in the trace over the step() calls that admitted nothing."""

import bisect

from benchmark import trace


def read(rec):
    if not rec.events:
        return None
    kernels = sorted(start for _, start, _ in trace.kernels(rec.events))
    plain = [s for s in rec.steps if not s["admitted"] and s["decode_steps"]]
    steps = sum(s["decode_steps"] for s in plain)
    if not kernels or not steps:
        return None
    count = sum(bisect.bisect_left(kernels, s["end"]) - bisect.bisect_left(kernels, s["start"])
                for s in plain)
    return count / steps
