"""Streaming text -> waveform synthesis (time-to-first-audio serving).

Port of ``nspeech_tpu/serving/streaming.py``. The one-shot path
(``pipeline.TextToSpeech``) decodes the whole utterance, runs the postnet
over the whole buffer, then vocodes the whole mel: first audio arrives
after the whole utterance's latency. :class:`StreamingTTS` chains the
decoder, the postnet and the vocoder in chunks instead, each stage lagging
the one before only as far as its exactness needs:

- decoder: ``start_autoregressive`` + ``scan_autoregressive_chunk`` give
  the one-shot decode's buffers;
- postnet: its convs see ``layers * (width // 2)`` frames to each side,
  so a window carved from within the ``[0, max_iters * r)`` decode buffer
  with that halo, the halo cropped off, equals the full-buffer postnet;
- vocoder: WaveNet is causal. The sampler resumes from its carried state
  (``CudaWaveNetGenerator.generate_chunk``: the CUDA kernel on the card,
  the plain version on the CPU), and the conditioning window is upsampled
  at absolute sample positions (``upsample_abs``), so every chunk sees the
  floats of the one-shot conditioning and samples its codes.

The stream is held to ``WaveNetVocoder.vocode_batch`` of its own mel
(codes and waveform identical at the same seed) and its mel to
``Tacotron2.forward``'s. Griffin-Lim is not streamed: its iteration is
global over the utterance.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Iterator

import numpy as np
import torch

from nspeech_tpu_torch import dsp
from nspeech_tpu_torch.config import stft_params
from nspeech_tpu_torch.data.feeder import round_up
from nspeech_tpu_torch.models import decoder as D
from nspeech_tpu_torch.ops.cuda.wavenet_gen import CudaWaveNetGenerator
from nspeech_tpu_torch.ops.upsample import upsample_abs
from nspeech_tpu_torch.serving.errors import ClientError, check_ids
from nspeech_tpu_torch.text import text_to_sequence
from nspeech_tpu_torch.text.symbols import PAD_ID

SEED = 0            # the sampler's noise key: WaveNetVocoder.vocode's default
MAX_GENERATORS = 8  # packed weight copies kept on the device, per speaker tuple


class StreamingTTS:
    """Chunked text -> wav through the WaveNet vocoder.

    ``chunk_frames`` mel frames (rounded up to a multiple of
    ``outputs_per_step``, capped at the decode buffer) make the first
    waveform chunk, ``chunk_frames * hop`` samples: time to first audio.
    Later vocoder launches double in length up to ``growth`` times that
    (``growth=1`` keeps them fixed), spreading the fixed cost of a launch
    and a delivery over more audio. The waveform is the same for any
    schedule; only the chunk boundaries move. The final chunk is trimmed
    to the utterance's stop frame.

    Runs on the device of ``synth`` and ``vocoder`` (``cuda`` unless both
    were made with ``device="cpu"``).
    """

    def __init__(self, synth, vocoder, chunk_frames: int = 40,
                 temperature: float = 1.0, text_bucket: int = 32,
                 growth: int = 4):
        if vocoder is None or vocoder.net is None:
            raise ValueError("StreamingTTS requires a loaded WaveNet "
                             "vocoder (Griffin-Lim cannot be streamed)")
        if vocoder.net.lc_channels <= 0:
            raise ValueError("vocoder has no local conditioning "
                             "(lc_channels=0); it cannot follow mels")
        if synth.device != vocoder.device:
            raise ValueError(f"synthesizer on {synth.device}, vocoder on "
                             f"{vocoder.device}")
        cfg = synth.cfg
        self.cfg = cfg
        self.device = synth.device
        self.model = synth.model
        self._params = synth._params
        self._bn = synth._bn_state
        self.net = vocoder.net
        self._vparams = vocoder._params
        self._hop = stft_params(cfg)[1]
        self._cleaners = [c.strip() for c in cfg.cleaners.split(",")]
        self._bucket = text_bucket
        r = cfg.outputs_per_step
        if chunk_frames % r:
            chunk_frames += r - chunk_frames % r
        self._temperature = float(temperature)
        self._stop = float(cfg.get("stop_threshold", 0.0))
        self._halo = cfg.postnet_conv_layers * (cfg.postnet_conv_width // 2)
        # The one-shot postnet input is exactly the [max_iters * r] decode
        # buffer: windows are carved from within it, so that their 0 / B
        # edges are the true boundaries where each conv's SAME padding
        # applies (zero fill outside it would feed the first conv data
        # where the one-shot pads, which bias and BN turn nonzero). A
        # window needs k + 2 * halo frames; smaller budgets postnet the
        # whole buffer at once.
        self._buf_frames = cfg.max_iters * r
        self.k = min(chunk_frames, self._buf_frames)
        self._k_steps = self.k // r
        self._whole_postnet = self._buf_frames < self.k + 2 * self._halo
        # Launch sizes: the first stays at V (it gates time to first
        # audio), then they double up to growth * V.
        self._V = self.k * self._hop
        top = self._V * max(1, int(growth))
        self._Vs = [self._V]
        while self._Vs[-1] < top:
            self._Vs.append(min(self._Vs[-1] * 2, top))
        # decoder and postnet chunk multipliers follow the launch ramp
        self._Ms = [max(1, Vn // self._V) for Vn in self._Vs]
        self._W = self._W_of(self._V)
        # First-window prefix: encoder, the decoder steps and the postnet
        # rows the first chunk needs, before the first launch. The window
        # starts at the true 0 boundary with an interior halo crop on the
        # right, the property the later windows rely on.
        n0 = -(-(self._W + self._halo) // r)
        self._prefix_frames = n0 * r
        self._use_prefix = (not self._whole_postnet and n0 <= cfg.max_iters
                            and self._buf_frames >= self._W + self._halo)
        self._gens: "OrderedDict[object, CudaWaveNetGenerator]" = OrderedDict()

    def _W_of(self, V: int) -> int:
        """Conditioning window frames for a V-sample launch: every sample
        of [s0, s0+V) interpolates rows floor(pos/hop) and +1, and s0
        need not be frame-aligned: V//hop + 3 covers the worst case."""
        return V // self._hop + 3

    # -- stages ---------------------------------------------------------------

    def _start(self, ids, lengths, spk):
        """Encoder and decoder step 0: (step, out0 [N, r*M], decoder
        carry). Batch-padding rows (length 0) are finished at step 0."""
        ctx, cell0 = self.model.attention_context(self._params, self._bn,
                                                  ids, lengths, spk)
        step = self.model.make_eval_step(self._params, ctx)
        (out0, _), carry = D.start_autoregressive(
            step, cell0, ids.shape[0], self.cfg.num_mels, self.cfg.max_iters,
            stop_threshold=self._stop, initial_finished=lengths < 1)
        return step, out0, carry

    def _decode(self, step, carry, n_steps: int):
        """``n_steps`` decoder steps: (frames [N, n_steps * r, M], carry)."""
        (outs, _), carry = D.scan_autoregressive_chunk(
            step, carry, n_steps, self.cfg.num_mels, stop_threshold=self._stop)
        return D.assemble_outputs(outs, self.cfg.num_mels), carry

    def _postnet(self, window: torch.Tensor) -> torch.Tensor:
        return window + self.model.postnet_residual(self._params, self._bn,
                                                    window)

    def _prefix(self, ids, lengths, spk):
        """(step, carry, decoded frames [N, prefix_frames, M], mel of the
        first W frames)."""
        step, out0, carry = self._start(ids, lengths, spk)
        n_steps = self._prefix_frames // self.cfg.outputs_per_step
        frames, carry = self._decode(step, carry, n_steps - 1)
        dec0 = torch.cat([D.assemble_outputs(out0[None], self.cfg.num_mels),
                          frames], dim=1)
        mel0 = self._postnet(dec0[:, : self._W + self._halo])
        return step, carry, dec0, mel0[:, : self._W]

    def _generator(self, gc_key) -> CudaWaveNetGenerator:
        """The sampler for a speaker tuple (None: unconditioned). Each
        packs its own weight copy on the device (6.9 MB at full width),
        and a multi-speaker server sees many tuples, so the cache is a
        bounded LRU."""
        gen = self._gens.pop(gc_key, None)
        if gen is None:
            while len(self._gens) >= MAX_GENERATORS:
                self._gens.popitem(last=False)
            gen = CudaWaveNetGenerator(
                self.net, self._vparams,
                gc_ids=None if gc_key is None else list(gc_key))
        self._gens[gc_key] = gen
        return gen

    def _to_host(self, wav: torch.Tensor):
        """Start the copy of a launch's waveform to the host; returns
        (host tensor, event to wait on or None). On the card the copy is
        queued right behind the launch into pinned memory, so a delivery
        waits for its own launch only, not for the launches and decoder
        chunks queued after it on the same stream."""
        if wav.device.type != "cuda":
            return wav, None
        host = torch.empty(wav.shape, dtype=wav.dtype, pin_memory=True)
        host.copy_(wav, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    # -- host pipeline --------------------------------------------------------

    def stream(self, text: str, speaker_id: int = -1) -> Iterator[np.ndarray]:
        """Yield waveform chunks (float32; the final chunk trimmed to the
        utterance's stop frame). Single-stream form of
        :meth:`stream_batch`."""
        for chunks in self.stream_batch([text], [speaker_id]):
            if chunks[0] is not None and len(chunks[0]):
                yield chunks[0]

    @torch.no_grad()
    def stream_batch(self, texts, speaker_ids=None):
        """Stream N utterances concurrently through one batched pipeline.

        Yields lists aligned with ``texts``: element i is stream i's next
        waveform chunk (float32), or None when stream i has no samples
        this round (it ended; streams stop at their own stop frame while
        the batch runs on for the longest). The decoder, the postnet and
        the vocoder advance in lockstep for all N streams: one sampler
        launch per chunk, one 8-CTA cluster per stream on the card.
        Speaker ids the Tacotron-2 speaker table or the vocoder's gc table
        lacks raise :class:`ClientError` before any launch (a deliberate
        deviation from JAX, which serves NaN rows).

        Per-stream trimming follows the decoder's stop frames; the
        conditioning's frame clip is the batch maximum, as in the one-shot
        ``TextToSpeech.synthesize_batch`` / ``vocode_batch``.

        After the last round: ``last_mels`` (each stream's mel up to its
        stop frame), ``last_mel_batch`` (the untrimmed batch, what
        ``vocode_batch`` would receive), ``last_mel``,
        ``last_total_frames`` (stream 0's) and ``last_launch_to_delivery``
        (seconds from each launch's start to its chunk's delivery).
        """
        cfg, r, k, halo = self.cfg, self.cfg.outputs_per_step, self.k, self._halo
        dev, hop = self.device, self._hop
        n_real = len(texts)
        if speaker_ids is None:
            speaker_ids = [-1] * n_real
        # ids the speaker or gc tables lack raise ClientError before any
        # launch (JAX serves NaN rows; on the card the index would be a
        # device-side assert that leaves the CUDA context unusable)
        given = [s for s in speaker_ids if s is not None and s >= 0]
        if cfg.num_speakers > 1:
            check_ids(given, cfg.num_speakers, "speaker id")
        if self.net.gc_channels:
            check_ids(given, self.net.gc_cardinality, "gc id")
        # Pad the batch to a power of two (synthesize_batch's rule).
        # Padding rows get length 0: the decoder finishes them at step 0,
        # so they never extend the batch's decode, and delivery drops them.
        N = max(1, 1 << (n_real - 1).bit_length())
        seqs = [text_to_sequence(t, self._cleaners) for t in texts]
        padded = round_up(max(max(len(sq) for sq in seqs), 1), self._bucket)
        ids = np.full((N, padded), PAD_ID, np.int64)
        for i, sq in enumerate(seqs):
            ids[i, : len(sq)] = sq
        lengths = np.zeros((N,), np.int64)
        lengths[:n_real] = [len(sq) for sq in seqs]
        spk = np.zeros((N,), np.int64)
        spk[:n_real] = [0 if (s is None or s < 0) else s for s in speaker_ids]
        gc_key = None
        if self.net.gc_channels:
            missing = [s is None or s < 0 for s in speaker_ids]
            if any(missing) and not all(missing):
                raise ClientError(
                    "stream_batch: cannot mix explicit speaker_ids and "
                    "-1/None (unconditioned) in one vocoder batch")
            if not any(missing):
                gc_key = tuple(int(s) for s in spk)
        ids, lengths, spk = (torch.from_numpy(a).to(dev) for a in (ids, lengths, spk))

        B = self._buf_frames           # the one-shot postnet input size
        dec = torch.zeros(N, B, cfg.num_mels, device=dev)   # decode buffer
        mel = torch.zeros(N, B, cfg.num_mels, device=dev)   # postnet'ed
        if self._use_prefix:
            step, carry, dec0, mel0 = self._prefix(ids, lengths, spk)
            head = min(self._prefix_frames, B)   # decoded frames so far
            dec[:, :head] = dec0[:, :head]
            mel_head = self._W                   # postnet'ed frames so far
            mel[:, :mel_head] = mel0
            steps_done = self._prefix_frames // r
        else:
            step, out0, carry = self._start(ids, lengths, spk)
            dec[:, :r] = D.assemble_outputs(out0[None], cfg.num_mels)
            head, mel_head, steps_done = r, 0, 1
        gen = self._generator(gc_key)
        voc_carry = gen.chunk_carry0(N)
        Q = self.net.quantization_channels
        launches = 0                   # position on the launch ramp
        s = 0                          # next sample to vocode (all streams)
        budget = cfg.max_iters
        row_done = np.zeros((N,), bool)
        row_total = np.full((N,), B, np.int64)   # frames, once a row stopped
        total_max = None               # the batch's frames, once known
        self.last_launch_to_delivery = []

        def next_V() -> int:
            return self._Vs[min(launches, len(self._Vs) - 1)]

        def pull_stops():
            nonlocal row_done, row_total
            row_done = carry[3].cpu().numpy().copy()
            if row_done.any():
                stops = np.minimum(carry[4].cpu().numpy(), budget)
                row_total = np.where(row_done, stops * r, B)

        def mel_m() -> int:
            """Postnet window multiplier: 1 until first audio is out, then
            the largest ramp multiplier whose window fits in B."""
            m = 1 if launches == 0 else self._Ms[-1]
            while m > 1 and (m * k + 2 * halo > B or m not in self._Ms):
                m //= 2
            return m

        def mel_ready(upto: int):
            """Extend the postnet'ed mel over frames [0, upto) with
            windows carved from within [0, B): interior edges keep a full
            halo, the window start is clamped into the buffer."""
            nonlocal mel_head
            while mel_head < upto:
                b = mel_head
                km = mel_m() * k
                if self._whole_postnet:
                    w0, win = 0, dec
                else:
                    w0 = min(max(b - halo, 0), B - (km + 2 * halo))
                    win = dec[:, w0: w0 + km + 2 * halo]
                out = self._postnet(win)
                n = min(km, B - b)
                mel[:, b: b + n] = out[:, b - w0: b - w0 + n]
                mel_head = b + n

        def vocode_next():
            """Launch the sampler over samples [s, s + V) of every stream;
            returns the pending chunk (host copy, event, s0, launch time)."""
            nonlocal s, voc_carry, launches
            V = next_V()
            if total_max is not None:      # the tail: stop at the end (the
                V = min(V, total_max * hop - s)   # samples past it are cut)
            W = self._W_of(V)
            launches += 1
            t_launch = time.perf_counter()
            f0 = s // hop
            fe = (s + V) // hop + 2        # highest frame row touched
            mel_ready(min(fe + 1, total_max if total_max is not None else B, B))
            avail = min(f0 + W, mel_head) - f0
            win = torch.empty(N, W, cfg.num_mels, device=dev)
            win[:, :avail] = mel[:, f0: f0 + avail]
            if avail < W:                                  # edge hold
                win[:, avail:] = win[:, avail - 1: avail]
            # a clip this far from the end does not bind, as in the
            # one-shot; the batch total binds the tail (the one-shot batch
            # path clips every stream at the batch maximum too)
            clip_total = total_max if total_max is not None else fe + 2
            lc = upsample_abs(win, f0, s, hop, V, clip_total)
            codes, voc_carry = gen.generate_chunk(
                voc_carry, V, seed=SEED, lc=lc, temperature=self._temperature)
            host, ready = self._to_host(dsp.mu_law_decode(codes, Q))
            s0, s = s, s + V
            return host, ready, s0, t_launch

        def deliver(item):
            host, ready, s0, t_launch = item
            if ready is not None:
                ready.synchronize()
            wav = host.numpy()             # [N, V]; padding rows dropped
            self.last_launch_to_delivery.append(time.perf_counter() - t_launch)
            out = []
            for i in range(n_real):
                if row_done[i]:
                    m = min(wav.shape[1], int(row_total[i]) * hop - s0)
                    out.append(wav[i, :m] if m > 0 else None)
                else:
                    out.append(wav[i])
            return out

        # The first chunk is delivered as soon as its launch ends (time to
        # first audio); each later chunk is held until the next launch is
        # queued, so its delivery overlaps that launch.
        pending = None
        first_sent = False

        def emit(item):
            nonlocal pending, first_sent
            if not first_sent:
                first_sent = True
                return [item]
            held, pending = pending, item
            return [] if held is None else [held]

        if self._use_prefix:
            # the prefix decoded and postnet'ed the first window: launch
            # now unless every stream already stopped (then the tail loop
            # vocodes it with the binding frame clip)
            pull_stops()
            if not row_done.all():
                for item in emit(vocode_next()):
                    yield deliver(item)

        while True:
            pull_stops()
            if row_done.all() or steps_done >= budget:
                break
            # launch every chunk whose exactness window is decoded: its
            # conditioning needs postnet'ed rows through (s + V) // hop + 2,
            # and postnet'ing row b needs decoded rows through b + m*k + halo
            while head >= min((s + next_V()) // hop + 3 + mel_m() * k + halo, B):
                for item in emit(vocode_next()):
                    yield deliver(item)
            # 1 chunk until first audio is out (it gates time to first
            # audio), then the ramp's largest
            m_dec = 1 if launches == 0 else self._Ms[-1]
            got, carry = self._decode(step, carry, m_dec * self._k_steps)
            n = min(got.shape[1], B - head)  # frames past the budget are not
            if n > 0:                        # in the one-shot buffer: drop
                dec[:, head: head + n] = got[:, :n]
            head = min(head + got.shape[1], B)
            steps_done += m_dec * self._k_steps

        pull_stops()
        row_total = np.minimum(carry[4].cpu().numpy(), budget) * r
        row_done[:] = True
        total_max = int(row_total.max())
        while s < total_max * hop:
            for item in emit(vocode_next()):
                yield deliver(item)
        if pending is not None:
            yield deliver(pending)
        self.last_mels = [mel[i, : int(row_total[i])].cpu().numpy()
                          for i in range(n_real)]
        self.last_mel_batch = mel[:n_real, :total_max].cpu().numpy()
        self.last_mel = self.last_mels[0]
        self.last_total_frames = int(row_total[0])

    def synthesize(self, text: str, speaker_id: int = -1) -> np.ndarray:
        """The stream, concatenated."""
        chunks = list(self.stream(text, speaker_id))
        return (np.concatenate(chunks)
                if chunks else np.zeros((0,), np.float32))

    def synthesize_batch(self, texts, speaker_ids=None):
        """Each stream of :meth:`stream_batch`, concatenated: a list of
        waveforms."""
        parts = [[] for _ in texts]
        for chunks in self.stream_batch(texts, speaker_ids):
            for i, c in enumerate(chunks):
                if c is not None and len(c):
                    parts[i].append(c)
        return [np.concatenate(p) if p else np.zeros((0,), np.float32)
                for p in parts]
