"""Admission (``ContinuousBatcher._admit``: the padded prefill and the slot
write), host ms an admission, in the offline cells."""

from benchmark.metrics import _serve


def read(rec):
    return _serve.admit_ms(rec)
