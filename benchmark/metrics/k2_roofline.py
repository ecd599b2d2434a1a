"""Linear layer (``ops/linear.py`` -> ``bfp_matmul`` -> K2 ``int8_kernel``
behind ``actq_split_kernel``): the bound of the decode steps' K2 calls over
the device time of those two kernels in the trace, in %."""

from benchmark import roofline


def read(rec):
    if not rec.events:
        return None
    t = sum(d for n, _, d in rec.events if "int8_kernel" in n or "actq_split_kernel" in n)
    steps = sum(s["decode_steps"] for s in rec.steps)
    if t <= 0 or not steps:
        return None
    m = rec.traffic["batcher"]["num_slots"]
    per_step = sum(roofline.k2_bound_s(m, n, k, rec.peaks)
                   for n, k in roofline.llama_linears(rec.dims))
    return 100.0 * steps * rec.dims["num_hidden_layers"] * per_step / t
