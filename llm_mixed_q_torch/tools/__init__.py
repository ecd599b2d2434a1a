"""Probe entry points of the port, run on the card:

- ``python -m llm_mixed_q_torch.tools.ksub``: stage knock-outs of the
  sub-byte dequant-matmul in both layouts (P8, P9; the TPU probe
  ``tools/ksub.py``);
- ``python -m llm_mixed_q_torch.tools.kvariants``: its dequant arithmetic
  (P1; ``tools/kvariants.py``);
- ``python -m llm_mixed_q_torch.tools.kvariants2``: its scale storage, and
  bf16 scales for the int8 matmul (P3, P2; ``tools/kvariants2.py``);
- ``python -m llm_mixed_q_torch.tools.kprobe``: the column tile of the
  lane-major sub-byte matmul (P4; ``tools/kprobe.py``);
- ``python -m llm_mixed_q_torch.tools.ktune7b``: the column tile, K per
  step and K split of the int8 matmul, and the tiles per step of the
  lane-major sub-byte one (P6, P5, P7; ``tools/ktune7b.py``);
- ``python -m llm_mixed_q_torch.tools.aprobe``: stage knock-outs of decode
  attention over the pos-major cache (P11; the TPU probe
  ``tools/aprobe.py``);
- ``python -m llm_mixed_q_torch.tools.k3``: more of them with bf16 dots,
  the prob quantizer taken apart (P12), and resident masks (P13;
  ``tools/k3.py``);
- ``python -m llm_mixed_q_torch.tools.kexp``: the scale expansion of a
  block-scaled dequant (P10; ``tools/kexp.py``).

Their kernels (``csrc/probes/``) are copies of the serving kernels with
stages knocked out, the arithmetic varied or the grid reshaped, or (P10)
a small kernel of its own, built into a library of their own; no serving
path launches them.
"""

from .aprobe import attention_probe
from .k3 import attention_v2, attention_v3
from .kexp import expand_probe
from .kprobe import subbyte_tile
from .ksub import subbyte_probe
from .ktune7b import band_sum, int8_tile
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
            "probe_attention": attention_probe.launches,
            "probe_attention_v2": attention_v2.launches,
            "probe_attention_v3": attention_v3.launches,
            "probe_expand": expand_probe.launches,
            "probe_subbyte_tile": subbyte_tile.launches,
            "probe_int8_tile": int8_tile.launches,
            "probe_band_sum": band_sum.launches}


def reset_launch_counts():
    for fn in (subbyte_probe, matmul_variant, sub_variant):
        fn.launches = dict.fromkeys(fn.launches, 0)
    for fn in (int8_variant, attention_probe, attention_v2, attention_v3, expand_probe,
               subbyte_tile, int8_tile, band_sum):
        fn.launches = 0
