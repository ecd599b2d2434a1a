"""Random weights made on the device from the seed: the draw that every
family's ``families/<family>.py`` cuts its tensors from.

Each part of a model (a decoder layer, the embeddings) comes from a
generator of its own, seeded from (seed, part), in one draw of normals
that is cut into its tensors. So the program's set-up and the reference
can each make any layer again, alone and in the same bits.
"""

from __future__ import annotations

import math

import torch


def part_seed(seed: int, part: int) -> int:
    return (int(seed) * 1_000_003 + part) % (2**63 - 1)


def draws(seed: int, part: int, shapes: dict, std: float, device) -> dict:
    """N(0, std) tensors of ``shapes`` (name -> shape), from one draw."""
    gen = torch.Generator(device=device)
    gen.manual_seed(part_seed(seed, part))
    total = sum(math.prod(s) for s in shapes.values())
    buf = torch.randn(total, generator=gen, device=device).mul_(std)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        out[name] = buf[at:at + n].view(shape)
        at += n
    return out
