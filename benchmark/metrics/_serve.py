"""Shared arithmetic of the serving readers (host-clock spans of the
harness's ``step()`` calls)."""


def step_ms_decode(rec):
    """Host ms a decode step, over the step() calls that admitted nothing."""
    plain = [s for s in rec.steps if not s["admitted"] and s["decode_steps"]]
    n = sum(s["decode_steps"] for s in plain)
    if not n:
        return None
    return 1e3 * sum(s["end"] - s["start"] for s in plain) / n


def admit_ms(rec):
    """Host ms an admission: each admitting step() call less its decode
    steps at ``step_ms_decode``."""
    per_step = step_ms_decode(rec)
    adm = [s for s in rec.steps if s["admitted"]]
    if not adm or per_step is None:
        return None
    return sum(1e3 * (s["end"] - s["start"]) - s["decode_steps"] * per_step
               for s in adm) / len(adm)
