"""WaveNet sampler: the CUDA kernel ``csrc/wavenet_gen.cu`` and its wrapper.

Replaces the Pallas TPU kernel of ``nspeech_tpu/ops/pallas/wavenet_gen.py``
(``PallasWaveNetGenerator``) in all its forms: one-shot (batch 1, and
batch B with per-stream speakers), primed from seed codes, and carried
state for streaming. :class:`CudaWaveNetGenerator` has the surface of
``PallasWaveNetGenerator.__call__``, ``chunk_carry0`` and
``generate_chunk``: on CUDA tensors it launches the kernel (or raises); on
CPU tensors it runs the plain versions, ``WaveNet.generate`` and
``WaveNet.generate_chunk``, which compute the same recurrence and draw the
same Philox noise one PyTorch op at a time.

The kernel runs one 8-CTA thread-block cluster per stream: rank 0 runs
the layer chain, and ranks 1-7 share the lc projection (one step ahead,
off the chain) and the skip sum, post-net and argmax (the "head"). Its
weight layout (:func:`pack_params`) is the port's own, not the TPU's
128-lane packing: the filter and gate halves of each layer's chain input
are one matrix ``wfg_chain`` (with the previous layer's dense product
folded in), the lc rows another, ``wlc``; the head's weights are packed
per head rank (:func:`pack_head`); the per-stream bias (layer biases plus
the speaker's gc projection) is computed here in PyTorch. The carry is
``WaveNet.generate_carry0``'s: ``(t0, code [B], prev [B], rings [B, sum(d),
R])``, the kernel's own ring layout, so a carry made on the card resumes
in the plain version and the other way round.

Each form counts its own launches: :data:`SAMPLER` (one-shot),
:data:`PRIMED_SAMPLER` (primed) and :data:`CARRIED_SAMPLER` (streaming).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from nspeech_tpu_torch.ops.cuda.build import build

SOURCE = "wavenet_gen.cu"
MAX_LAYERS = 480   # within the kernel's threads less one warp (csrc/wavenet_gen.cu)


def pack_params(net, params, gc_ids=None) -> Dict[str, torch.Tensor]:
    """WaveNet params -> the kernel's float32 contiguous layout, on the
    params' device. ``bfg`` is [L, G, 2DC] with G = len(gc_ids) (1 without
    speakers). Each layer's [2R + M, 2DC] input matrix is split: the rows
    of the chain input ``[ring state | current]`` go to ``wfg_chain``, the
    lc rows to ``wlc`` [L, M, 2DC] (M = 0 without local conditioning).

    The chain folds each layer's dense product into the next layer, as
    the TPU kernel does: layer l's input ``current_l = current_{l-1} +
    gated_{l-1} @ Wd_{l-1} + bd_{l-1}`` enters its gates as ``[state_l |
    current_{l-1} | gated_{l-1}]`` times ``[Ws_l; Wc_l; Wd_{l-1} @ Wc_l]``
    with ``bd_{l-1} @ Wc_l`` added to the bias, so ``wfg_chain`` is [L,
    2DC, 2R + DC] (the last DC columns are zero for layer 0), and the
    dense product that updates ``current`` runs beside the gates. So
    ``wdense`` [L, R, DC] and ``bdense`` [L, R] hold at row l the dense
    weights of layer l - 1 (zeros at row 0; the last layer's are never
    used). The chain's matrices are output-major, so that the lanes of a
    warp reduce one output over consecutive shared-memory banks."""
    layers = params["layers"]
    R, DC, S, Q, M = (net.residual_channels, net.dilation_channels,
                      net.skip_channels, net.quantization_channels,
                      net.lc_channels)
    dev = params["causal"].device
    gc = net._embed_gc(params, gc_ids)                   # [G, C] or None
    G = 1 if gc is None else gc.shape[0]
    wchain, wlc, bfg, wdense, bdense, wskip = [], [], [], [], [], []
    bskip = torch.zeros(S, device=dev)
    wd_prev = torch.zeros(DC, R, device=dev)
    bd_prev = torch.zeros(R, device=dev)
    for lp in layers:
        wcur = torch.cat([lp["filter"][1], lp["gate"][1]], dim=1)  # [R, 2DC]
        wchain.append(torch.cat([
            torch.cat([lp["filter"][0], lp["gate"][0]], dim=1), wcur,
            wd_prev @ wcur], dim=0))                  # [2R + DC, 2DC]
        wlc.append(torch.cat([lp["lc_filter"][0], lp["lc_gate"][0]], dim=1)
                   if M else torch.zeros(0, 2 * DC, device=dev))
        b = (bd_prev @ wcur).expand(G, 2 * DC)
        if net.use_biases:
            b = b + torch.cat([lp["filter_bias"], lp["gate_bias"]])
        if gc is not None:
            b = b + gc @ torch.cat([lp["gc_filter"][0], lp["gc_gate"][0]], dim=1)
        bfg.append(b)
        wdense.append(wd_prev)
        bdense.append(bd_prev)
        wd_prev = lp["dense"][0]
        bd_prev = (lp["dense_bias"] if net.use_biases
                   else torch.zeros(R, device=dev))
        wskip.append(lp["skip"][0])
        if net.use_biases:
            bskip = bskip + lp["skip_bias"]
    zeros = torch.zeros
    wskip = torch.cat(wskip, dim=0)                       # [L*DC, S]
    packed = {
        "wc": params["causal"],                           # [2, Q, R]
        "wfg_chain": torch.stack(wchain).transpose(1, 2),  # [L, 2DC, 2R + DC]
        "wlc": torch.stack(wlc),                          # [L, M, 2DC]
        "bfg": torch.stack(bfg),
        "wdense": torch.stack(wdense).transpose(1, 2),    # [L, R, DC]
        "bdense": torch.stack(bdense),
        "head": pack_head(wskip, params["post1"][0], params["post2"][0]),
        "bskip": bskip,
        "b1": params.get("post1_bias", zeros(S, device=dev)),
        "b2": params.get("post2_bias", zeros(Q, device=dev)),
    }
    packed = {k: v.to(torch.float32).contiguous() for k, v in packed.items()}
    packed["dilations"] = torch.tensor(net.dilations, dtype=torch.int32,
                                       device=dev)
    return packed


HEAD_RANKS = 7   # kHeads: the cluster's ranks 1-7 (csrc/wavenet_gen.cu)
STAMP_STEPS, STAMP_MARKS = 64, 18  # kStampSteps, kMarks (csrc/wavenet_gen.cu)


def head_columns(n: int, h: int) -> slice:
    """Head rank h's columns of an n-column head matrix: its share of the
    n / 4 groups of 4 (the kernel's ``head_groups``)."""
    return slice(4 * (h * (n // 4) // HEAD_RANKS),
                 4 * ((h + 1) * (n // 4) // HEAD_RANKS))


def pack_head(wskip, post1, post2) -> torch.Tensor:
    """The head's weights as the kernel streams them: for each head rank
    in turn, its columns of ``wskip`` [L*DC, S], of ``post1`` [S, S] and of
    ``post2`` [S, Q], each block row-major and contiguous."""
    S, Q = post1.shape[1], post2.shape[1]
    blocks = []
    for h in range(HEAD_RANKS):
        cs, qs = head_columns(S, h), head_columns(Q, h)
        blocks += [wskip[:, cs].reshape(-1), post1[:, cs].reshape(-1),
                   post2[:, qs].reshape(-1)]
    return torch.cat(blocks)


def _widths(packed: Dict[str, torch.Tensor]) -> Tuple[int, ...]:
    """(L, R, DC, S, Q, M) of a packed parameter set."""
    _, Q, R = packed["wc"].shape
    L, M, F = packed["wlc"].shape
    return L, R, F // 2, packed["bskip"].shape[0], Q, M


class WaveNetSampler:
    """Launches ``wavenet_sample`` and counts its launches. With
    ``stamps=True`` it launches the build with ``-DWAVENET_STAMPS``, which
    writes per-phase timer stamps for stream 0 (a measurement build: no
    path of the package uses it)."""

    def __init__(self, stamps: bool = False):
        self.launches = 0
        self._defines = ("WAVENET_STAMPS",) if stamps else ()
        self._lib = None

    def _library(self):
        if self._lib is None:
            lib, _ = build(SOURCE, self._defines)
            fn = lib.wavenet_sample
            fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 10
                           + [ctypes.c_ulonglong, ctypes.c_float,
                              ctypes.c_ulonglong, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            occ = lib.wavenet_max_active_clusters
            occ.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
            occ.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def max_active_clusters(self, packed: Dict[str, torch.Tensor]) -> int:
        """How many streams (8-CTA clusters) run at once at the widths of
        ``packed`` on the current card; a larger batch runs in waves."""
        L, R, DC, S, _, M = _widths(packed)
        out = ctypes.c_int(0)
        with torch.cuda.device(packed["wc"].device):
            rc = self._library().wavenet_max_active_clusters(
                L, R, DC, S, M, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA "
                               f"error {rc}")
        return out.value

    def __call__(self, packed: Dict[str, torch.Tensor],
                 lc: Optional[torch.Tensor], n_samples: int, batch: int,
                 temperature: float, seed: int, rings: torch.Tensor,
                 state: torch.Tensor, t0: int,
                 forced: Optional[torch.Tensor] = None,
                 stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Codes [batch, n_samples] int32 from the kernel, run from the
        carried state, which it updates in place: ``rings`` [batch,
        sum(d), R] float32, ``state`` [batch, 2] int32 (next input code,
        previous input code or -1), ``t0`` the absolute index of the first
        sample. ``lc`` is [batch, >= n_samples, M] float32 (None when
        M == 0). ``forced`` [batch, P] int32 replaces the input code of
        the absolute steps < P (priming); the codes of steps < P - 1 are
        then not computed (the kernel stores the next forced code).
        ``stamps`` [STAMP_STEPS, STAMP_MARKS] int64 receives the stamps of
        a ``stamps=True`` sampler."""
        dev = packed["wc"].device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA sampler needs CUDA tensors, got {dev}")
        for name, v in packed.items():
            want = torch.int32 if name == "dilations" else torch.float32
            if v.device != dev or v.dtype != want or not v.is_contiguous():
                raise ValueError(f"packed[{name!r}] must be a contiguous "
                                 f"{want} tensor on {dev}")
        two = packed["wc"].shape[0]
        L, R, DC, S, Q, M = _widths(packed)
        F = 2 * DC
        if two != 2 or any(c % 4 for c in (R, DC, S, Q)) or L > MAX_LAYERS:
            raise ValueError("the sampler needs filter_width 2, R, DC, S, Q "
                             f"multiples of 4 and at most {MAX_LAYERS} layers")
        if n_samples < 1 or t0 < 0:
            raise ValueError(f"need n_samples >= 1 and t0 >= 0, got "
                             f"{n_samples} and {t0}")
        G = packed["bfg"].shape[1]
        bfg = packed["bfg"]
        if G == 1 and batch > 1:
            bfg = bfg.expand(L, batch, F).contiguous()
        elif G != batch:
            raise ValueError(f"{G} speakers for a batch of {batch}")
        ring_rows = int(packed["dilations"].sum())
        for name, v, shape, dtype in (
                ("rings", rings, (batch, ring_rows, R), torch.float32),
                ("state", state, (batch, 2), torch.int32)):
            if (tuple(v.shape) != shape or v.dtype != dtype or v.device != dev
                    or not v.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous {dtype} "
                                 f"tensor of shape {shape} on {dev}")
        forced_ptr, prime_len = None, 0
        if forced is not None:
            if (forced.dim() != 2 or forced.shape[0] != batch
                    or forced.dtype != torch.int32 or forced.device != dev
                    or not forced.is_contiguous()):
                raise ValueError(f"seed codes must be a contiguous int32 "
                                 f"tensor [{batch}, P] on {dev}")
            prime_len = forced.shape[1]
            if prime_len and not 0 <= int(forced.min()) <= int(forced.max()) < Q:
                raise ValueError(f"seed codes must lie in [0, {Q})")
            forced_ptr = forced.data_ptr() if prime_len else None
        lc_ptr = None
        if M:
            if lc is None or lc.shape[0] != batch or lc.shape[2] != M:
                raise ValueError(f"lc must be [{batch}, T, {M}]")
            if lc.device != dev or lc.dtype != torch.float32:
                raise ValueError(f"lc must be float32 on {dev}")
            if lc.shape[1] < n_samples:
                lc = torch.nn.functional.pad(lc, (0, 0, 0, n_samples - lc.shape[1]))
            lc = lc[:, :n_samples].contiguous()
            lc_ptr = lc.data_ptr()
        stamps_ptr = None
        if self._defines:
            if (stamps is None or stamps.dtype != torch.int64
                    or tuple(stamps.shape) != (STAMP_STEPS, STAMP_MARKS)
                    or stamps.device != dev or not stamps.is_contiguous()):
                raise ValueError(f"a stamped launch needs stamps, a contiguous "
                                 f"int64 [{STAMP_STEPS}, {STAMP_MARKS}] tensor "
                                 f"on {dev}")
            stamps_ptr = stamps.data_ptr()
        codes = torch.empty(batch, n_samples, dtype=torch.int32, device=dev)
        inv_t = 1.0 / temperature if temperature > 0.0 else 0.0
        fn = self._library().wavenet_sample
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*(packed[k].data_ptr() for k in (
                "wc", "wfg_chain")), packed["wlc"].data_ptr() if M else None,
                bfg.data_ptr(), *(packed[k].data_ptr() for k in (
                    "wdense", "bdense", "head", "bskip", "b1", "b2",
                    "dilations")),
                lc_ptr, forced_ptr, rings.data_ptr(), state.data_ptr(),
                codes.data_ptr(), stamps_ptr, batch, n_samples, L, R, DC, S,
                Q, M, ring_rows, prime_len, t0, inv_t,
                seed & 0xFFFFFFFFFFFFFFFF, stream)
        if rc != 0:
            raise RuntimeError(f"wavenet_sample launch failed: CUDA error {rc}")
        self.launches += 1
        return codes


SAMPLER = WaveNetSampler()            # one-shot launches (K1, K2)
PRIMED_SAMPLER = WaveNetSampler()     # primed launches (K3)
CARRIED_SAMPLER = WaveNetSampler()    # carried-state launches (K4)


class CudaWaveNetGenerator:
    """Reusable generator: params are packed once per speaker set.

    Same call surface as the TPU package's ``PallasWaveNetGenerator``;
    refuses what that refuses (scalar input, filter_width != 2)."""

    def __init__(self, net, params, gc_ids=None):
        if net.scalar_input or net.filter_width != 2:
            raise NotImplementedError(
                "WaveNet sampler: one-hot filter_width=2 only")
        self.net = net
        self.params = params
        self.gc_ids = gc_ids
        self.device = params["causal"].device
        self.packed = (pack_params(net, params, gc_ids)
                       if self.device.type == "cuda" else None)

    def _check_lc(self, lc, batch: int) -> torch.device:
        """Validates the conditioning; returns the device to run on."""
        use_lc = lc is not None
        if use_lc and not self.net.lc_channels:
            raise ValueError("model has lc_channels=0; cannot condition")
        if self.net.lc_channels and not use_lc:
            raise ValueError("locally-conditioned model needs lc=")
        if use_lc and lc.shape[0] != batch:
            raise ValueError(f"lc batch {lc.shape[0]} != generation batch {batch}")
        dev = lc.device if use_lc else self.device
        if dev != self.device:
            raise ValueError(f"lc on {dev}, weights on {self.device}")
        return dev

    def __call__(self, n_samples: int, seed: int = 0, batch: int = 1,
                 seed_codes=None, lc: Optional[torch.Tensor] = None,
                 temperature: float = 1.0,
                 deterministic: bool = False) -> torch.Tensor:
        """Mu-law codes [batch, n_samples] int32. ``seed_codes`` [batch, P]
        primes the generation: they are the inputs of the first P steps,
        and the first code returned is the prediction after the last of
        them (an empty seed primes nothing). ``lc`` is per-sample
        conditioning [batch, >= P + n_samples, M]. Temperature <= 0 (or
        ``deterministic``) is argmax."""
        dev = self._check_lc(lc, batch)
        if seed_codes is not None:
            seed_codes = torch.as_tensor(seed_codes)
            if seed_codes.dim() != 2 or seed_codes.shape[0] != batch:
                raise ValueError(f"seed_codes must be [{batch}, P], got "
                                 f"{tuple(seed_codes.shape)}")
            if seed_codes.shape[1] == 0:
                seed_codes = None
        if deterministic:
            temperature = 0.0
        if dev.type == "cpu":
            return self.net.generate(self.params, n_samples, seed=seed,
                                     batch=batch, gc_ids=self.gc_ids, lc=lc,
                                     seed_codes=seed_codes,
                                     temperature=temperature)
        _, code, prev, rings = self.chunk_carry0(batch)
        state = torch.stack([code, prev], dim=1).contiguous()
        if seed_codes is None:
            return SAMPLER(self.packed, lc, n_samples, batch, temperature,
                           seed, rings, state, 0)
        # step t's code is the prediction for t + 1: the first kept code is
        # step P - 1's, so the launch runs P - 1 + n_samples steps
        P = seed_codes.shape[1]
        codes = PRIMED_SAMPLER(self.packed, lc, P - 1 + n_samples, batch,
                               temperature, seed, rings, state, 0,
                               forced=seed_codes)
        return codes[:, P - 1:]

    def chunk_carry0(self, batch: int = 1):
        """Initial carry for :meth:`generate_chunk` (the fresh state of a
        one-shot generation), on the weights' device."""
        return self.net.generate_carry0(batch, device=self.device)

    def generate_chunk(self, carry, n_samples: int, seed: int = 0,
                       lc: Optional[torch.Tensor] = None,
                       temperature: float = 1.0, final: bool = False
                       ) -> Tuple[torch.Tensor, Optional[tuple]]:
        """Continue a generation: ``n_samples`` (any count >= 1) steps from
        ``carry``; returns ``(codes [B, n_samples] int32, new carry)``, the
        carry None with ``final=True``. ``carry`` itself is left as it
        was, so a generation can resume from it again. Chained chunks give
        the codes of one :meth:`__call__` with the same seed, at every
        temperature (ring slots and noise follow the absolute index)."""
        t0, code, prev, rings = carry
        batch = code.shape[0]
        dev = self._check_lc(lc, batch)
        if dev.type == "cpu":
            codes, new = self.net.generate_chunk(
                self.params, carry, n_samples, seed=seed, gc_ids=self.gc_ids,
                lc=lc, temperature=temperature)
        else:
            rings = rings.clone()
            state = torch.stack([code, prev], dim=1).to(torch.int32).contiguous()
            codes = CARRIED_SAMPLER(self.packed, lc, n_samples, batch,
                                    temperature, seed, rings, state, int(t0))
            new = (int(t0) + n_samples, state[:, 0], state[:, 1], rings)
        return codes, (None if final else new)
