"""Seeded weights on the device, from a shape tree.

A shape tree (``reference/*.py`` ``param_shapes``) gives every leaf as
``(shape, init)``. All leaves come from one ``torch.rand`` call of a
generator on the device, seeded from the run's seed and a salt per
model, then one multiply and one add by per-element half-widths and
centres: a few large calls, float32, never on the host. Each leaf is a
view of that buffer. The same seed gives the same weights."""

from __future__ import annotations

import math

import torch

from benchmark.reference.nn import leaf_inits


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _half_width(init):
    if init[0] == "glorot":
        return 0.0, math.sqrt(6.0 / (init[1] + init[2]))
    return leaf_inits()[init[0]]


def _build(tree, views):
    if isinstance(tree, dict):
        return {k: _build(v, views) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_build(v, views) for v in tree]
    return next(views)


def make(trees, seed: int, salt: int, device) -> list:
    """The trees of ``trees`` (a list of shape trees) filled from one draw:
    a list of tensor trees of the same structure."""
    specs = [leaf for t in trees for _, leaf in _leaves(t)]
    sizes = [math.prod(shape) for shape, _ in specs]
    centre, half = zip(*(_half_width(init) for _, init in specs))
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 2654435761 + salt) % (2 ** 63))
    n = torch.tensor(sizes, device=device)
    flat = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    flat.mul_(torch.repeat_interleave(torch.tensor(half, device=device), n))
    flat.add_(torch.repeat_interleave(torch.tensor(centre, device=device), n))
    views, offset = [], 0
    for (shape, _), size in zip(specs, sizes):
        views.append(flat[offset:offset + size].view(shape))
        offset += size
    it = iter(views)
    return [_build(t, it) for t in trees]

