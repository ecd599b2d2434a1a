"""Device: the share of the traced window with no operation on the card,
in % (serving cells)."""

from benchmark import trace


def read(rec):
    if not rec.events or rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(rec.events) / rec.window_s)
