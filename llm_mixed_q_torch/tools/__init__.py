"""Probe entry points of the port, run on the card:

- ``python -m llm_mixed_q_torch.tools.ksub``: stage knock-outs of the
  sub-byte dequant-matmul in both layouts (P8, P9; the TPU probe
  ``tools/ksub.py``);
- ``python -m llm_mixed_q_torch.tools.aprobe``: stage knock-outs of decode
  attention over the pos-major cache (P11; the TPU probe
  ``tools/aprobe.py``).

Their kernels (``csrc/probes/``) are copies of the serving kernels with
stages knocked out, built into a library of their own; no serving path
launches them.
"""

from .aprobe import attention_probe
from .ksub import subbyte_probe


def launch_counts() -> dict[str, int]:
    """Launches of each probe kernel, by the name chip_smoke.py reports."""
    return {"probe_subbyte_t": subbyte_probe.launches["transposed"],
            "probe_subbyte": subbyte_probe.launches["lane_major"],
            "probe_attention": attention_probe.launches}


def reset_launch_counts():
    subbyte_probe.launches = dict.fromkeys(subbyte_probe.launches, 0)
    attention_probe.launches = 0
