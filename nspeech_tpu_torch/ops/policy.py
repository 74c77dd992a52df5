"""The mixed-precision compute policy (``compute_dtype`` hparam): port of
``nspeech_tpu/ops/policy.py``.

* Master parameters, optimizer state and batch-norm statistics stay
  float32: checkpoints and the optimizer do not change.
* Each forward casts the parameter tree and its floating inputs to
  ``compute_dtype`` at entry (:func:`entry_cast`), so the products see
  bf16 operands.
* Products accumulate in float32 and round once to the compute dtype
  (``ops/layers.py`` ``acc_dot``): on the card cuBLAS's bf16 GEMMs with
  reduced-precision reductions off (``set_matmul_precision``), on the
  CPU the same float32-accumulating kernels.
* Batch-norm moments, softmax normalizers and losses are computed in
  float32 (:func:`upcast`).
* Gradients reach the float32 masters through the cast: autograd's
  backward of ``.to(bfloat16)`` is a cast back.

bf16 needs no loss scaling (its exponent range is float32's).
``compute_dtype=float32``, the default, leaves every tree as it is: the
float32 port is unchanged bit for bit, and a float64 run (the card
against the CPU) keeps its precision.
"""

from __future__ import annotations

from collections import defaultdict

import torch

from nspeech_tpu_torch.utils.tree import tree_leaves, tree_map

# the JAX trainers' --matmul-precision values
MATMUL_PRECISIONS = ("highest", "tensorfloat32", "bfloat16")


def compute_dtype(cfg) -> torch.dtype:
    """The forward's dtype from the ``compute_dtype`` hparam."""
    name = str(cfg.get("compute_dtype", "float32") or "float32")
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"compute_dtype must be a float dtype, got {name}")
    return dtype


def cast_floats(tree, dtype: torch.dtype):
    """Cast every floating leaf of ``tree`` to ``dtype``; integer and bool
    leaves and ``None`` pass through, and a leaf already in ``dtype`` is
    returned as it is.

    The leaves to cast are concatenated per (device, dtype) into one flat
    buffer, cast in one launch and split back into views of it: an eager
    cast leaf by leaf would add a launch per leaf (404 for WaveNet) to
    every forward. The values are those of the leafwise cast."""
    if tree is None:
        return None
    groups = defaultdict(list)
    for leaf in tree_leaves(tree):
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and leaf.dtype != dtype):
            groups[(leaf.device, leaf.dtype)].append(leaf)
    if not groups:
        return tree
    cast = {}
    for leaves in groups.values():
        uniq = list({id(t): t for t in leaves}.values())
        if len(uniq) == 1:
            cast[id(uniq[0])] = uniq[0].to(dtype)
            continue
        flat = torch.cat([t.reshape(-1) for t in uniq]).to(dtype)
        for t, part in zip(uniq, flat.split([t.numel() for t in uniq])):
            cast[id(t)] = part.view(t.shape)
    return tree_map(lambda x: cast.get(id(x), x), tree)


def entry_cast(tree, dtype: torch.dtype):
    """A model's entry cast: :func:`cast_floats` to a reduced
    ``compute_dtype``; the default float32 leaves ``tree`` as it is (so a
    float64 tree stays float64)."""
    return tree if dtype == torch.float32 else cast_floats(tree, dtype)


def carry_dtype(cfg) -> torch.dtype:
    """The dtype of a decoder's zero carries: the reduced compute dtype, or
    torch's default dtype under the default float32 (so a run under
    ``torch.set_default_dtype(torch.float64)`` keeps float64 carries)."""
    dtype = compute_dtype(cfg)
    return torch.get_default_dtype() if dtype == torch.float32 else dtype


def upcast(x: torch.Tensor) -> torch.Tensor:
    """A floating ``x`` in float32, or as it is when it is float32 or
    wider (or not floating): where the policy computes statistics and
    losses."""
    if not x.is_floating_point():
        return x
    return x.to(torch.promote_types(x.dtype, torch.float32))


def set_matmul_precision(name: str) -> None:
    """Apply one of the JAX trainers' ``--matmul-precision`` values to the
    card's float32 products and convolutions, and turn off cuBLAS's
    reduced-precision (bf16 split-K) reductions for bf16 GEMMs, so that
    they accumulate in float32 as the policy asks. Called for a CUDA
    device only: on the CPU the products stay float32 whatever the flag.

    ``highest``: float32, TF32 off for matmuls and cuDNN (the port's
    default). ``tensorfloat32``: TF32 on for both. ``bfloat16``: PyTorch's
    ``set_float32_matmul_precision("medium")``, which asks for bf16-pass
    float32 products where the backend has them; on the H100 the products
    run TF32 (``chip_smoke.py``'s bf16 phase tells bf16, TF32 and float32
    apart by a product whose low mantissa bits matter)."""
    if name not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul precision {name!r} not in {MATMUL_PRECISIONS}")
    torch.set_float32_matmul_precision(
        {"highest": "highest", "tensorfloat32": "high", "bfloat16": "medium"}[name])
    torch.backends.cudnn.allow_tf32 = name != "highest"
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
