"""The whole step: model operations of the served tokens (prompts and
outputs; padding and idle slots not counted) over the window's seconds at
the card's dense bf16 peak, in %."""

from benchmark import roofline


def read(rec):
    if not rec.steps or rec.window_s <= 0:
        return None
    return 100.0 * roofline.model_flops_serve(rec.steps, rec.dims) / (rec.window_s * rec.peaks[2])
