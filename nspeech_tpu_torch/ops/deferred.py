"""Deferred weight gradients for the products inside the Tacotron loops.

Port of ``nspeech_tpu/ops/deferred.py``. Autograd through a Python loop
whose step computes ``y_t = x_t @ W`` forms ``x_t^T dy_t`` at every step
and adds it into W's full-size gradient: one GEMM and one read-modify-
write of the whole [in, out] buffer per step and weight (PERF.md: in a
float32 Tacotron-2 step, ``add_`` of those gradients took 40% of the
card's time). The deferred form:

1. inside the loop the weight and bias enter detached (the JAX package's
   ``stop_gradient``), so autograd forms only ``dx_t``;
2. the pre-activation passes through a tap (:class:`Taps`), an identity
   whose backward copies its adjoint ``dz_t`` (the full adjoint, every
   recurrent path included) into step t's slot of a stacked buffer
   [S, B, out], allocated once per forward; the tap also keeps the
   product's input ``x_t``;
3. after the backward pass ``dW = sum_t x_t^T dz_t`` is one GEMM over the
   stacked steps and ``db = sum dz`` one reduction (:func:`matmul_grads`,
   :func:`bilstm_wh_grads`).

The gradient is the same chain rule, reassociated: it equals autograd's
up to the order of its sums.

In a tensor-parallel step (``tp``) the taps hold this model rank's
widths: a column-parallel cell taps its units' columns of ``dz`` with the
whole input, the row-parallel frame projection taps the whole ``dz``
with the rank's input columns, so :func:`matmul_grads` and
:func:`bilstm_wh_grads` give each rank its slice of the weight gradient.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from nspeech_tpu_torch.ops import layers as L
from nspeech_tpu_torch.parallel import collectives

Params = Dict[str, torch.Tensor]


class _Tap(torch.autograd.Function):
    """Identity; the backward copies the adjoint into ``buf[t]``."""

    @staticmethod
    def forward(ctx, x, buf, t):
        ctx.buf, ctx.t = buf, t
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.buf[ctx.t].copy_(grad)
        return grad, None, None


class Taps:
    """The per-step adjoints and product inputs of one deferred forward.

    ``shapes`` maps each deferred product to its adjoints' shape [S, B,
    out] (S steps). Step t of a product is its t-th :meth:`tap`; its
    adjoints land in ``dz[name]`` (zeros where no gradient reaches), its
    inputs in ``inputs[name]``. The buffers take the pre-activation's
    dtype, at least float32."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]]):
        self.shapes = {k: tuple(v) for k, v in shapes.items()}
        self.dz: Dict[str, torch.Tensor] = {}
        self.inputs: Dict[str, list] = {k: [] for k in shapes}

    def __contains__(self, name: str) -> bool:
        return name in self.shapes

    def tap(self, name: str, pre: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``pre`` unchanged, its adjoint routed into the next step's slot
        of ``dz[name]``; ``x`` (detached) is that step's product input."""
        steps = self.inputs[name]
        shape = self.shapes[name]
        if len(steps) >= shape[0] or tuple(pre.shape) != shape[1:]:
            raise ValueError(f"deferred {name}: step {len(steps)} of shape "
                             f"{tuple(pre.shape)} does not fit {shape}")
        if name not in self.dz:
            self.dz[name] = torch.zeros(
                shape, device=pre.device,
                dtype=torch.promote_types(pre.dtype, torch.float32))
        t = len(steps)
        steps.append(x.detach())
        return _Tap.apply(pre, self.dz[name], t)

    def stacked(self, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(inputs [S, B, in], adjoints [S, B, out]) of a product whose S
        steps all ran."""
        steps = self.inputs[name]
        if len(steps) != self.shapes[name][0]:
            raise ValueError(f"deferred {name}: {len(steps)} of "
                             f"{self.shapes[name][0]} steps ran")
        return torch.stack(steps), self.dz[name]


def dense_deferred(params: Params, x: torch.Tensor, taps: Taps, name: str,
                   activation=None, tp=None) -> torch.Tensor:
    """``layers.dense`` with the kernel's and bias's gradients deferred;
    with ``tp``, ``layers.row_dense``."""
    y = L.acc_dot(x, params["kernel"].detach())
    if tp is not None:
        y = collectives.reduce_from_model(y, tp)
    if "bias" in params:
        y = y + params["bias"].detach()
    y = taps.tap(name, y, x)
    return activation(y) if activation is not None else y


def lstm_cell_deferred(params: Params, x: torch.Tensor,
                       state: Tuple[torch.Tensor, torch.Tensor], taps: Taps,
                       name: str, forget_bias: float = 1.0, tp=None):
    """``layers.lstm_cell`` (with ``tp``: its column-parallel form) with
    deferred weight gradients: returns ``(h, (c, h))``."""
    c, h = state
    xh = torch.cat([x, h], dim=-1)
    xin = xh if tp is None else collectives.copy_to_model(xh, tp)
    pre = L.acc_dot(xin, params["kernel"].detach()) + params["bias"].detach()
    new_c, new_h = L._lstm_gates(taps.tap(name, pre, xh), c, forget_bias)
    return new_h, (new_c, L.gather_blocks(new_h, tp))


def gru_cell_deferred(params: Params, x: torch.Tensor, h: torch.Tensor,
                      taps: Taps, name: str) -> torch.Tensor:
    """``layers.gru_cell`` with deferred gradients for both kernels (the
    products ``<name>_gate`` and ``<name>_cand``); returns the new
    state."""
    xh = torch.cat([x, h], dim=-1)
    pre = (L.acc_dot(xh, params["gate_kernel"].detach())
           + params["gate_bias"].detach())
    r, u = torch.chunk(torch.sigmoid(taps.tap(name + "_gate", pre, xh)), 2,
                       dim=-1)
    xrh = torch.cat([x, r * h], dim=-1)
    pre = (L.acc_dot(xrh, params["cand_kernel"].detach())
           + params["cand_bias"].detach())
    c = torch.tanh(taps.tap(name + "_cand", pre, xrh))
    return u * h + (1.0 - u) * c


def _product(x: torch.Tensor, dz: torch.Tensor, spec: str) -> torch.Tensor:
    """``einsum(spec, x, dz)`` with ``dz`` rounded to ``x``'s dtype and the
    sum in at least float32 (the JAX package's
    ``preferred_element_type=float32``)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return torch.einsum(spec, x.to(acc), dz.to(x.dtype).to(acc))


def matmul_grads(inputs: torch.Tensor, dz: torch.Tensor,
                 kernel: str = "kernel", bias: str = "bias") -> Params:
    """Weight gradients from stacked steps: ``inputs`` [S, B, in], ``dz``
    [S, B, out] -> ``{kernel: [in, out], bias: [out]}``, one GEMM and one
    reduction."""
    x2 = inputs.reshape(-1, inputs.shape[-1])
    dz2 = dz.reshape(-1, dz.shape[-1])
    return {kernel: _product(x2, dz2, "ki,ko->io"), bias: dz2.sum(dim=0)}


def bilstm_wh_grads(h_entry: torch.Tensor,
                    dz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recurrent-kernel gradients of the one-loop BiLSTM
    (``layers.bilstm_rnn`` with taps): ``h_entry`` [T, 2N, H] (each step's
    entry state; rows :N forward, N: backward) and ``dz`` [T, 2N, 4H] ->
    ``(dwh_fw, dwh_bw)``, each [H, 4H]: the last H rows of each
    direction's [C + H, 4H] kernel. Its first C rows and the biases get
    their gradients from autograd through the hoisted input product."""
    t, two_n, h = h_entry.shape
    hs = h_entry.reshape(t, 2, two_n // 2, h)
    dzs = dz.reshape(t, 2, two_n // 2, -1)
    dwh = _product(hs, dzs, "tgnh,tgnz->ghz")
    return dwh[0], dwh[1]
