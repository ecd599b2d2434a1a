"""Decode attention (``kernels/attention_decode.py``, K4 ``k4_*_kernel``;
K5 ``k5_*_kernel``): the bound of the live requests' filled positions over
the device time of those kernels in the trace, in %."""

from benchmark import roofline


def read(rec):
    if not rec.events:
        return None
    t = sum(d for n, _, d in rec.events if "k4_" in n or "k5_" in n)
    filled = sum(s["filled"] for s in rec.steps)
    rows = sum(s["row_steps"] for s in rec.steps)
    if t <= 0 or not filled:
        return None
    L = rec.dims["num_hidden_layers"]
    nbytes = L * roofline.attn_bytes(filled, rows, rec.dims)
    flops = L * roofline.attn_flops(filled, rec.dims)
    return 100.0 * max(nbytes / rec.peaks[0], flops / rec.peaks[1]) / t
