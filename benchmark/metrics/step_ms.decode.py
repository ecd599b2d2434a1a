"""Model step (``decode_step``), host ms a decode step of the batcher."""

from benchmark.metrics import _serve


def read(rec):
    return _serve.step_ms_decode(rec)
