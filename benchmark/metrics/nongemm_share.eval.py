"""Quantizers (``ops/quantizers/``) in the PTQ forward: the share of the
device's kernel time outside cuBLAS GEMM kernels, by kernel name, in %."""

GEMM = ("gemm", "nvjet", "xmma", "cutlass", "cublas")


def read(rec):
    if not rec.events:
        return None
    total = sum(d for _, _, d in rec.events)
    gemm = sum(d for n, _, d in rec.events if any(g in n.lower() for g in GEMM))
    if total <= 0:
        return None
    return 100.0 * (total - gemm) / total
