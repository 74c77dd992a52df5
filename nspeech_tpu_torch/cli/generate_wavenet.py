"""WaveNet autoregressive sampling from a checkpoint.

    python -m nspeech_tpu_torch.cli.generate_wavenet CKPT_DIR [options]

Port of the JAX package's ``generate_wavenet.py``, on the port's serving
checkpoint (``train/checkpoint.py``; a JAX run's checkpoint is exported to
it by ``scripts/export_torch_checkpoint.py``). On ``--device cuda`` (the
default) every route runs the CUDA sampler, the JAX CLI's ``--pallas``
route: primed from ``--wav_seed`` (kernel form K3), unprimed (K1/K2), or
chunk by chunk into the wav file with ``--stream-chunk`` (carried state,
K4). ``--device cpu`` runs the plain PyTorch generator, the counterpart of
the JAX CLI's scan route. Supports global conditioning (``--gc-id``) and
mel conditioning from a saved spectrogram (``--mel-npy``). As the JAX CLI
does, each route opens ``metrics.jsonl`` beside the output wav for its
audio summary, which the port (without TensorBoard) leaves empty.
"""

from __future__ import annotations

import argparse
import os
import struct
import time

import numpy as np
import torch

from nspeech_tpu_torch.config import stft_params
from nspeech_tpu_torch.data.wavenet_feeder import upsample_frames
from nspeech_tpu_torch.dsp import mu_law_decode, mu_law_encode
from nspeech_tpu_torch.dsp.trim import trim_silence
from nspeech_tpu_torch.dsp.wavio import (encode_pcm16, load_wav, save_wav,
                                         wav_stream_header)
from nspeech_tpu_torch.models import create_model
from nspeech_tpu_torch.ops.cuda.wavenet_gen import CudaWaveNetGenerator
from nspeech_tpu_torch.serving.errors import ClientError, check_ids
from nspeech_tpu_torch.train import config_from_checkpoint, load_serving_params
from nspeech_tpu_torch.utils.metrics import MetricWriter


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stream(args, cfg, net, gen, lc, device) -> None:
    """``--stream-chunk``: one carried launch per chunk, each chunk
    written to the wav as it arrives (fixed gain, RIFF sizes patched at the
    end). The last launch runs only the samples still owed."""
    k, Q = args.stream_chunk, net.quantization_channels
    carry = gen.chunk_carry0(1)
    chunks, first = [], None
    _sync(device)
    start = time.time()
    with open(args.wav_out_path, "wb") as f:
        f.write(wav_stream_header(cfg.sample_rate))
        for off in range(0, args.samples, k):
            n = min(k, args.samples - off)
            lc_chunk = None
            if lc is not None:
                lc_chunk = np.zeros((1, n, lc.shape[2]), np.float32)
                have = min(n, lc.shape[1] - off)
                if have > 0:
                    lc_chunk[:, :have] = lc[:, off: off + have]
                lc_chunk = torch.from_numpy(lc_chunk).to(device)
            codes, carry = gen.generate_chunk(carry, n, seed=args.seed,
                                              lc=lc_chunk,
                                              temperature=args.temperature)
            wav_c = mu_law_decode(codes[0].cpu(), Q).numpy()
            if first is None:
                first = time.time() - start
            chunks.append(wav_c)
            f.write(encode_pcm16(wav_c))
        # finalize the RIFF sizes now that the length is known
        data_bytes = 2 * sum(len(c) for c in chunks)
        f.seek(4)
        f.write(struct.pack("<I", 36 + data_bytes))
        f.seek(40)
        f.write(struct.pack("<I", data_bytes))
    elapsed = time.time() - start
    total = sum(len(c) for c in chunks)
    rate = total / elapsed
    print("Streamed %d samples in %.2fs (%.0f samples/sec, %.2fx real "
          "time; first %d-sample chunk after %.2fs)"
          % (total, elapsed, rate, rate / cfg.sample_rate,
             min(k, args.samples), first))
    print("Wrote %s" % args.wav_out_path)
    _audio_summary(args, cfg, np.concatenate(chunks))


def _audio_summary(args, cfg, wav: np.ndarray) -> None:
    """The JAX CLI's audio summary beside the output wav."""
    writer = MetricWriter(os.path.dirname(os.path.abspath(args.wav_out_path)))
    writer.audio(0, "generated_audio", wav, cfg.sample_rate)
    writer.close()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="On cuda every route launches the CUDA sampler kernel (the "
               "JAX CLI's --pallas route): primed with --wav_seed, unprimed "
               "otherwise, carried chunk by chunk with --stream-chunk. "
               "--device cpu runs the plain PyTorch generator (the JAX CLI's "
               "scan route).")
    parser.add_argument("checkpoint", help="Checkpoint directory")
    parser.add_argument("--checkpoint-step", type=int, default=None)
    parser.add_argument("--model", default=None,
                        help="Model name (default: checkpoint run metadata, "
                             "else 'wavenet')")
    parser.add_argument("--hparams", default="")
    parser.add_argument("--samples", type=int, default=16000)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--wav_out_path", default="generated.wav")
    parser.add_argument("--wav_seed", default=None,
                        help="Wav file to prime generation from")
    parser.add_argument("--gc-id", type=int, default=None,
                        help="Speaker id for global conditioning")
    parser.add_argument("--gc-cardinality", type=int, default=None)
    parser.add_argument("--mel-npy", default=None,
                        help=".npy mel spectrogram [T, M] for local conditioning")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--stream-chunk", type=int, default=0, metavar="N",
                        help="Stream N samples per launch into the output "
                             "wav as they are generated (carried state "
                             "across launches) instead of one launch; "
                             "reports time to first audio")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the sampler kernel) or cpu (the plain "
                             "generator)")
    args = parser.parse_args(argv)
    if args.stream_chunk and args.wav_seed:
        raise SystemExit("--stream-chunk streams the carried generator; it "
                         "does not combine with --wav_seed priming")
    device = torch.device(args.device)

    cfg, args.model = config_from_checkpoint(
        args.checkpoint, args.model, args.hparams, default_model="wavenet")
    if args.gc_cardinality is not None:
        cfg.gc_category_cardinality = args.gc_cardinality
    if args.gc_id is not None and cfg.gc_channels <= 0:
        raise SystemExit("--gc-id given but gc_channels is 0 in hparams")
    if args.gc_id is not None:
        # checked before any launch: on the card an id past the gc table is
        # a device-side assert (the JAX CLI generates from NaN rows)
        try:
            check_ids([args.gc_id], cfg.gc_category_cardinality, "--gc-id")
        except ClientError as e:
            raise SystemExit(str(e)) from None

    net = create_model(args.model, cfg)
    params, _ = load_serving_params(args.checkpoint, net,
                                    step=args.checkpoint_step, device=device)
    print("Receptive field: %d" % net.receptive_field)
    gc_ids = None if args.gc_id is None else [args.gc_id]

    seed_codes = None
    if args.wav_seed:
        seed_wav = load_wav(args.wav_seed, cfg.sample_rate)
        seed_wav = trim_silence(seed_wav, cfg.silence_threshold)
        codes = mu_law_encode(seed_wav, net.quantization_channels).numpy()
        seed_codes = codes[None, -net.receptive_field:]
        print("Primed with %d seed samples" % seed_codes.shape[1])

    lc = None
    if args.mel_npy:
        mel = np.load(args.mel_npy)
        _, hop, _ = stft_params(cfg)
        total = (seed_codes.shape[1] if seed_codes is not None else 0) + args.samples
        lc = upsample_frames(mel, hop, total)[None]
        print("Local conditioning: mel %s -> %d samples" % (mel.shape, total))

    gen = CudaWaveNetGenerator(net, params, gc_ids=gc_ids)
    if args.stream_chunk:
        _stream(args, cfg, net, gen, lc, device)
        return

    lc_t = None if lc is None else torch.from_numpy(lc).to(device)
    seed_t = (None if seed_codes is None
              else torch.from_numpy(np.ascontiguousarray(seed_codes)).to(device))
    _sync(device)
    start = time.time()
    with torch.no_grad():
        codes = gen(args.samples, seed=args.seed, seed_codes=seed_t, lc=lc_t,
                    temperature=args.temperature)
    codes = codes.cpu()  # blocks until done
    elapsed = time.time() - start
    rate = args.samples / elapsed
    print("Generated %d samples in %.2fs (%.0f samples/sec, %.2fx real time)"
          % (args.samples, elapsed, rate, rate / cfg.sample_rate))

    wav = mu_law_decode(codes[0], net.quantization_channels).numpy()
    save_wav(wav, args.wav_out_path, cfg.sample_rate)
    print("Wrote %s" % args.wav_out_path)
    _audio_summary(args, cfg, wav)


if __name__ == "__main__":
    main()
