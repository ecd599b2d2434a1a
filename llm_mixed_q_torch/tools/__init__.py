"""Probe entry points of the port, run on the card:

- ``python -m llm_mixed_q_torch.tools.ksub``: stage knock-outs of the
  sub-byte dequant-matmul in both layouts (P8, P9; the TPU probe
  ``tools/ksub.py``);
- ``python -m llm_mixed_q_torch.tools.kvariants``: its dequant arithmetic
  (P1; ``tools/kvariants.py``);
- ``python -m llm_mixed_q_torch.tools.kvariants2``: its scale storage, and
  bf16 scales for the int8 matmul (P3, P2; ``tools/kvariants2.py``);
- ``python -m llm_mixed_q_torch.tools.aprobe``: stage knock-outs of decode
  attention over the pos-major cache (P11; the TPU probe
  ``tools/aprobe.py``).

Their kernels (``csrc/probes/``) are copies of the serving kernels with
stages knocked out or the arithmetic varied, built into a library of their
own; no serving path launches them.
"""

from .aprobe import attention_probe
from .ksub import subbyte_probe
from .kvariants import matmul_variant
from .kvariants2 import int8_variant, sub_variant


def launch_counts() -> dict[str, int]:
    """Launches of each probe kernel, by the name chip_smoke.py reports."""
    return {"probe_subbyte_t": subbyte_probe.launches["transposed"],
            "probe_subbyte": subbyte_probe.launches["lane_major"],
            "probe_matmul_variant_t": matmul_variant.launches["transposed"],
            "probe_matmul_variant": matmul_variant.launches["lane_major"],
            "probe_sub_variant_t": sub_variant.launches["transposed"],
            "probe_sub_variant": sub_variant.launches["lane_major"],
            "probe_int8_variant": int8_variant.launches,
            "probe_attention": attention_probe.launches}


def reset_launch_counts():
    for fn in (subbyte_probe, matmul_variant, sub_variant):
        fn.launches = dict.fromkeys(fn.launches, 0)
    int8_variant.launches = 0
    attention_probe.launches = 0
