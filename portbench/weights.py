"""Seeded weights, made on the device in a few large draws.

A model's weights are a list of ``Leaf(name, shape, init)``: ``("uniform",
bound)`` draws U(-bound, bound), ``("normal", std)`` N(0, std^2),
``("const", value)`` fills, ``("given", tensor)`` copies. All uniform
leaves come from one ``torch.rand`` call and all normal leaves from one
``torch.randn`` call on a CUDA generator seeded with the run's seed (a
CPU generator where the device is the CPU, in the tests), so the same
seed gives the same weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch


@dataclass
class Leaf:
    name: str
    shape: Tuple[int, ...]
    init: tuple


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for ``seed`` and a stream number."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1000003 + stream) % (2 ** 63))
    return g


def draw(leaves: List[Leaf], gen: torch.Generator, device
         ) -> Dict[str, torch.Tensor]:
    sizes = {kind: sum(_numel(leaf.shape) for leaf in leaves
                       if leaf.init[0] == kind)
             for kind in ("uniform", "normal")}
    pools = {"uniform": torch.rand(sizes["uniform"], generator=gen,
                                   device=device) * 2 - 1,
             "normal": torch.randn(sizes["normal"], generator=gen,
                                   device=device)}
    used = {"uniform": 0, "normal": 0}
    out = {}
    for leaf in leaves:
        kind, arg = leaf.init
        n = _numel(leaf.shape)
        if kind in pools:
            part = pools[kind][used[kind]:used[kind] + n].view(leaf.shape)
            used[kind] += n
            out[leaf.name] = part * arg
        elif kind == "const":
            out[leaf.name] = torch.full(leaf.shape, float(arg), device=device)
        elif kind == "given":
            out[leaf.name] = arg.to(device=device, dtype=torch.float32)
        else:
            raise ValueError(f"unknown init {kind!r} for {leaf.name}")
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
