"""actq_split's workspace layout since its redesign for Hopper.

``actq_split`` (the data_in quantizer of K2 and K3, once a call) runs a
block a row and 512 K, and flags each chunk of 512 K of a row where its lo
term is nonzero: lo_flags [M, kw / 512] bytes after hi and lo. K2 and K3 OR
a row block's chunk flags to decide whether to run the lo products. The
plain version ``actq_split_plain`` gives the same layout; here it is held
to the split the port computed before the redesign (hi = bf16(q), lo =
bf16(q - hi), a flag a row), bit for bit, at the decode and prefill rows
(M 1, 8 and 256) and at each Llama-2-7B projection's K (4096, and 11008
for down_proj, padded to the workspace's 11264), with the serving path's
quantizer (bfp_6bit.toml's data_in: [1, 16], width 6) and without (raw
float32 x, chunks of it bf16-exact so that flags differ from chunk to
chunk). The CUDA kernel is held against the plain version bit for bit on
the card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``)."""

import pytest
import torch

from llm_mixed_q_torch.kernels import dequant_matmul as dm

ACTQ = (16, 6, 8, 127)


def _x(m, k, raw):
    """x [m, k] from a seed; raw: chunk 1 of every row and all of row 0
    made bf16-exact (no lo there)."""
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(m * k)) * 3
    if raw:
        x[:, 512:1024] = x[:, 512:1024].to(torch.bfloat16).float()
        x[0] = x[0].to(torch.bfloat16).float()
    return x


def _split_before(x, actq, kw):
    """The split as the port computed it before the redesign: hi, lo
    [m, kw] and a flag a row."""
    q = x if actq is None else dm._actq_qdq(x, actq)
    q = torch.nn.functional.pad(q, (0, kw - q.shape[1]))
    hi = q.to(torch.bfloat16)
    lo = (q - hi.float()).to(torch.bfloat16)
    return hi, lo, (lo != 0).any(dim=1)


@pytest.mark.parametrize("actq", [None, ACTQ], ids=["raw", "actq"])
@pytest.mark.parametrize("k", [4096, 11008])
@pytest.mark.parametrize("m", [1, 8, 256])
def test_plain_split_keeps_its_bits_with_chunk_flags(m, k, actq):
    x = _x(m, k, actq is None)
    kw = -(-k // 512) * 512
    hi, lo, flags = dm.actq_split_plain(x, actq, kw)
    want_hi, want_lo, want_rows = _split_before(x, actq, kw)
    assert torch.equal(hi.view(torch.int16), want_hi.view(torch.int16))
    assert torch.equal(lo.view(torch.int16), want_lo.view(torch.int16))
    assert flags.shape == (m, kw // 512) and flags.dtype == torch.bool
    assert torch.equal(flags, (want_lo != 0).view(m, kw // 512, 512).any(dim=2))
    assert torch.equal(flags.any(dim=1), want_rows)
    if actq is None:  # the chunks made bf16-exact carry no flag, the others do
        assert not flags[:, 1].any() and not flags[0].any()
        assert flags[1:, 0].all() and flags[1:, 2:].all()
    else:  # block_fp at width 6 leaves no lo
        assert not flags.any()


@pytest.mark.parametrize("m,k_pad", [(1, 4096), (8, 11264), (256, 4480)])
def test_cpu_wrapper_returns_the_kernels_layout(m, k_pad):
    """``actq_split_cuda`` on a CPU tensor is the plain version padded to
    the workspace's kw, its flags shaped as the kernel writes them
    (``_split_workspace``)."""
    x = _x(m, 4096, True)
    hi, lo, flags = dm.actq_split_cuda(x, None, k_pad)
    kw, _, ws_hi, ws_lo, ws_flags = dm._split_workspace(m, k_pad, "cpu")
    assert hi.shape == ws_hi.shape == lo.shape == ws_lo.shape == (m, kw)
    assert flags.shape == ws_flags.shape == (m, kw // 512)
    assert all(torch.equal(a, b) for a, b in zip((hi, lo, flags),
                                                  dm.actq_split_plain(x, None, kw)))
