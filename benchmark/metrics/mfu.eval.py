"""The whole step: model operations of the evaluated tokens over the
window's seconds at the card's dense bf16 peak, in %."""

from benchmark import roofline


def read(rec):
    tokens = sum(b[2] for b in rec.batches)
    if not tokens or rec.window_s <= 0:
        return None
    flops = roofline.model_flops_eval(tokens, rec.traffic["seq_len"], rec.dims, rec.family)
    return 100.0 * flops / (rec.window_s * rec.peaks[2])
