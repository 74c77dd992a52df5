"""Evidence report for a TRAINED WaveNet vocoder: teacher-forced scoring,
ground-truth-mel copy synthesis, and text -> Tacotron-2 -> WaveNet.

    python -m nspeech_tpu_torch.cli.vocoder_report --taco-run TACO_RUN \
        --wavenet-run WAVENET_RUN --corpus CORPUS --out OUT_DIR

Port of the JAX package's ``scripts/vocoder_report.py``, with its flags
and JSON keys (``--device``, ``cuda`` by default; JAX's ``--no-pallas``
has no counterpart: on the card the sampler is the CUDA kernel, and a
failure to build or launch it raises). Three measurements:

1. **Teacher-forced** (does the model know the conditional?): one-step
   predictions of ``WaveNet.forward_train`` on a window of a real
   utterance and its upsampled mel: nll, the share of argmax codes within
   2 of the target, the median code error and the waveform correlation.
2. **Copy synthesis** (the vocoder alone): corpus utterances' mels
   (``dsp/audio.py`` ``spectrograms``) vocoded by ``WaveNetVocoder.vocode``
   (on the card the sampler kernel, one launch per utterance), then the
   L1 of the generated wav's mel against the conditioning mel, the
   agreement of their dominant-frequency tracks, spectral cosine and
   centroids; ``--sweep`` scores more temperatures.
3. **End to end** (text through both trained models):
   ``TextToSpeech.synthesize(..., return_gl=True)``, the WaveNet wav's mel
   against the predicted mel beside the Griffin-Lim route's; with
   ``--speakers``, every text for every speaker and the voice ratios.

Also plots the vocoder's training loss from the run's ``metrics.jsonl``
(``wavenet_loss.png``, with ln 256 as a reference line) and stacked mel
images (``copyN_mels.png``, ``e2eN_mels.png``), and writes ``report.json``.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os

import numpy as np
import torch

from nspeech_tpu_torch.utils.audio_metrics import (dominant_freq_track,
                                                   log_spectral_centroid,
                                                   median_f0, mel_l1,
                                                   spectral_cosine,
                                                   spectral_shift_ratio,
                                                   track_agreement)


def plot_mel_panel(path: str, panels) -> None:
    """The mels of ``panels`` ([(title, mel [T, M])]) stacked top to
    bottom, each min-max scaled on its own, 2 white rows between them,
    the shorter padded with black on the right. Titles are not drawn."""
    from nspeech_tpu_torch.utils.plot import png_gray8, specgram_image

    images = [specgram_image(np.asarray(mel)) for _, mel in panels]
    width = max(im.shape[1] for im in images)
    rows = []
    for i, im in enumerate(images):
        if i:
            rows.append(np.full((2, width), 255, np.uint8))
        rows.append(np.pad(im, ((0, 0), (0, width - im.shape[1]))))
    with open(path, "wb") as f:
        f.write(png_gray8(np.concatenate(rows)))


def plot_loss_curve(metrics_path: str, out_path: str):
    """The run's loss per logged step, beside ln 256; returns (last step,
    last loss), both None without loss rows (the plot then holds the line
    alone)."""
    from nspeech_tpu_torch.utils.plot import plot_curves

    steps, losses = [], []
    with open(metrics_path) as f:
        for line in f:
            rec = json.loads(line)
            if "loss" in rec:
                steps.append(rec["step"])
                losses.append(rec["loss"])
    span = [steps[0], steps[-1]] if steps else [0, 1]
    plot_curves(out_path, [("loss", steps, losses),
                           ("uniform (ln 256)", span, [math.log(256.0)] * 2)],
                "step", "NLL (nats/sample)")
    return steps[-1] if steps else None, losses[-1] if losses else None


def _copy_items(corpus: str, n: int):
    """[(wav_path, speaker_id_or_None)] for copy synthesis: LJSpeech
    layout (metadata.csv + wavs/) or VCTK layout (wav48/p*/, one
    utterance per speaker round-robin; the speaker index follows the
    feeder's sorted speaker map)."""
    meta = os.path.join(corpus, "metadata.csv")
    if os.path.exists(meta):
        with open(meta, encoding="utf-8") as f:
            rows = [line.strip().split("|")[0] for line in f][:n]
        return [(os.path.join(corpus, "wavs", r + ".wav"), None) for r in rows]
    spk_dirs = sorted(glob.glob(os.path.join(corpus, "wav48", "p*")))
    if not spk_dirs:
        raise SystemExit(f"{corpus}: neither metadata.csv nor wav48/")
    items = []
    i = 0
    while len(items) < n:
        spk = i % len(spk_dirs)
        wavs = sorted(glob.glob(os.path.join(spk_dirs[spk], "*.wav")))
        idx = i // len(spk_dirs)
        if idx >= len(wavs):
            break
        items.append((wavs[idx], spk))
        i += 1
    return items


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--taco-run", required=True,
                    help="Tacotron run dir (contains ckpt/)")
    ap.add_argument("--wavenet-run", required=True,
                    help="WaveNet run dir (contains ckpt/ and metrics.jsonl)")
    ap.add_argument("--corpus", required=True,
                    help="LJSpeech- or VCTK-layout corpus dir for copy synthesis")
    ap.add_argument("--out", default="vocoder_report")
    ap.add_argument("--n-copy", type=int, default=2,
                    help="corpus utterances for copy synthesis")
    ap.add_argument("--copy-seconds", type=float, default=3.0,
                    help="seconds of audio per copy-synthesis utterance")
    ap.add_argument("--texts", nargs="*", default=[
        "pqoc fjel azrv kmds wuh.",
        "tbi znogu chwad lyrfe qvk sjmp.",
    ])
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="sampling temperature for the shipped wavs "
                         "(0 = argmax, which tends to collapse to silence)")
    ap.add_argument("--sweep", nargs="*", type=float, default=[],
                    help="extra temperatures to score (metrics only)")
    ap.add_argument("--tf-window", type=int, default=4096,
                    help="teacher-forced scoring window (samples)")
    ap.add_argument("--speakers", default="",
                    help="comma-separated speaker ids: run the end-to-end "
                         "section once per (text, speaker) through the "
                         "speaker-conditioned pipeline (Tacotron-2 speaker "
                         "embedding + WaveNet gc) and report the "
                         "spectral-shift ratio of each speaker against the "
                         "first")
    ap.add_argument("--device", default="cuda",
                    help="cuda (one card: the sampler kernel) or cpu (the "
                         "plain generator)")
    return ap


def teacher_forced(voc, wav_path, spk, cfg, window: int, device) -> dict:
    """The teacher-forced section: logits of one window past the
    receptive field, at most 20,000 samples into the utterance."""
    from nspeech_tpu_torch.dsp.audio import spectrograms
    from nspeech_tpu_torch.dsp.mulaw import mu_law_decode
    from nspeech_tpu_torch.dsp.wavio import load_wav
    from nspeech_tpu_torch.ops.upsample import upsample_on_device

    tf_wav = load_wav(wav_path, cfg.sample_rate)
    rf = voc.net.receptive_field
    off = min(20000, max(len(tf_wav) - rf - window, 0))
    seg = np.asarray(tf_wav[off: off + rf + window], np.float32)[None]
    _, tf_mel = spectrograms(np.asarray(tf_wav, np.float32), cfg)
    with torch.no_grad():
        lc_full = upsample_on_device(torch.from_numpy(tf_mel)[None].to(device),
                                     voc._hop, len(tf_wav))
        lc_seg = lc_full[:, off: off + seg.shape[1]]
        gc = (torch.tensor([spk], dtype=torch.int64, device=device)
              if spk is not None and voc.net.gc_channels else None)
        logits, targets = voc.net.forward_train(
            voc._params, torch.from_numpy(seg).to(device), gc_ids=gc, lc=lc_seg)
        logits = logits.float().cpu().numpy()[0]
        targets = targets.cpu().numpy()[0]
    mx = logits.max(-1, keepdims=True)
    logp = logits - mx - np.log(np.sum(np.exp(logits - mx), -1, keepdims=True))
    pred = np.argmax(logits, -1)
    err = np.abs(pred.astype(int) - targets.astype(int))
    q = voc.net.quantization_channels
    w_pred = mu_law_decode(torch.from_numpy(pred), q).numpy()
    w_true = mu_law_decode(torch.from_numpy(targets), q).numpy()
    return {
        "window_samples": int(window),
        "nll": round(float(-np.mean(logp[np.arange(len(targets)), targets])), 4),
        "argmax_within_2_codes": round(float(np.mean(err <= 2)), 4),
        "median_abs_code_err": int(np.median(err)),
        "waveform_corr": round(float(np.corrcoef(w_pred, w_true)[0, 1]), 5),
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    from nspeech_tpu_torch.dsp.audio import spectrograms
    from nspeech_tpu_torch.dsp.wavio import load_wav, save_wav
    from nspeech_tpu_torch.serving import (Synthesizer, TextToSpeech,
                                           WaveNetVocoder)

    device = torch.device(args.device)
    voc = WaveNetVocoder.from_checkpoint(
        os.path.join(args.wavenet_run, "ckpt"), device=device)
    cfg = voc.cfg
    sr = cfg.sample_rate
    report = {"temperature": args.temperature}

    # -- training curve ----------------------------------------------------
    metrics_path = os.path.join(args.wavenet_run, "metrics.jsonl")
    if os.path.exists(metrics_path):
        step, loss = plot_loss_curve(
            metrics_path, os.path.join(args.out, "wavenet_loss.png"))
        report["train_final_step"] = step
        report["train_final_nll"] = loss

    # -- teacher-forced scoring --------------------------------------------
    rows = _copy_items(args.corpus, args.n_copy)
    report["teacher_forced"] = teacher_forced(voc, rows[0][0], rows[0][1], cfg,
                                              args.tf_window, device)

    # -- copy synthesis (ground-truth mel -> wav) --------------------------
    copies = []
    for i, (wav_path, spk) in enumerate(rows):
        ref = load_wav(wav_path, sr)[: int(args.copy_seconds * sr)]
        _, mel = spectrograms(ref, cfg)
        sweep = {}
        gen = None
        for t in args.sweep:
            g = voc.vocode(mel, speaker_id=spk, temperature=t)
            sweep[str(t)] = {
                "mel_l1": round(mel_l1(g, mel, cfg), 4),
                "freq_track_agreement": round(track_agreement(
                    dominant_freq_track(ref, sr), dominant_freq_track(g, sr)), 4)}
            if t == args.temperature:
                gen = g  # the shipped wav is this sweep point
        if gen is None:
            gen = voc.vocode(mel, speaker_id=spk, temperature=args.temperature)
        save_wav(gen, os.path.join(args.out, f"copy{i}_wavenet.wav"), sr)
        save_wav(ref, os.path.join(args.out, f"copy{i}_reference.wav"), sr)
        _, gen_mel = spectrograms(gen, cfg)
        plot_mel_panel(os.path.join(args.out, f"copy{i}_mels.png"),
                       [("conditioning mel (ground truth)", mel),
                        ("mel of WaveNet output", gen_mel)])
        entry = {"utterance": os.path.splitext(os.path.basename(wav_path))[0],
                 "speaker": spk, "mel_l1": round(mel_l1(gen, mel, cfg), 4),
                 "centroid_ref_hz": round(log_spectral_centroid(ref, sr), 1),
                 "centroid_gen_hz": round(log_spectral_centroid(gen, sr), 1),
                 "freq_track_agreement": round(track_agreement(
                     dominant_freq_track(ref, sr), dominant_freq_track(gen, sr)), 4),
                 "spectral_cosine": round(spectral_cosine(ref, gen, sr), 4)}
        if sweep:
            entry["sweep"] = sweep
        copies.append(entry)
    report["copy_synthesis"] = copies

    # -- end-to-end text -> taco2 -> wavenet -------------------------------
    synth = Synthesizer.from_checkpoint(os.path.join(args.taco_run, "ckpt"),
                                        device=device)
    tts = TextToSpeech(synth, voc)
    if args.speakers:
        speakers = [int(s) for s in args.speakers.split(",")]
        per_text = []
        for i, text in enumerate(args.texts):
            wavs, gls = {}, {}
            entry = {"text": text, "speakers": {}}
            for spk in speakers:
                wav, mel, _, wav_gl = tts.synthesize(
                    text, speaker_id=spk, temperature=args.temperature,
                    return_gl=True)
                wavs[spk] = wav
                gls[spk] = wav_gl
                save_wav(wav, os.path.join(args.out, f"e2e{i}_spk{spk}_wn.wav"), sr)
                n_frames = max(int(np.ceil(len(wav_gl) / voc._hop)), 1)
                entry["speakers"][str(spk)] = {
                    "seconds": round(len(wav) / sr, 2),
                    "rms": round(float(np.sqrt(np.mean(wav ** 2))), 4),
                    "wavenet_mel_l1_vs_predicted": round(
                        mel_l1(wav, mel[:n_frames], cfg), 4),
                    # voice preservation: ~1.0 means the vocoder kept the
                    # voice of the same decode's Griffin-Lim wav
                    "spectral_ratio_wn_vs_gl": round(spectral_shift_ratio(
                        gls[spk], wav, sr), 4),
                    "median_f0_wn": round(median_f0(wav, sr), 1),
                    "median_f0_gl": round(median_f0(gls[spk], sr), 1),
                    "centroid_wn_hz": round(log_spectral_centroid(wav, sr), 1),
                    "centroid_gl_hz": round(log_spectral_centroid(gls[spk], sr), 1),
                }
            ref_wav = wavs[speakers[0]]
            entry["spectral_ratio_vs_first_speaker"] = {
                str(s): round(spectral_shift_ratio(ref_wav, wavs[s], sr), 4)
                for s in speakers[1:]}
            # the same ratios on the deterministic Griffin-Lim route
            entry["griffinlim_spectral_ratio_vs_first_speaker"] = {
                str(s): round(spectral_shift_ratio(gls[speakers[0]], gls[s], sr), 4)
                for s in speakers[1:]}
            per_text.append(entry)
        # a gc-conditioned vocoder has no unconditioned route
        report["end_to_end_speakers"] = per_text
    else:
        e2e = []
        for i, text in enumerate(args.texts):
            wav, mel, _, wav_gl = tts.synthesize(
                text, temperature=args.temperature, return_gl=True)
            save_wav(wav, os.path.join(args.out, f"e2e{i}_wavenet.wav"), sr)
            save_wav(wav_gl, os.path.join(args.out, f"e2e{i}_griffinlim.wav"), sr)
            n_frames = max(int(np.ceil(len(wav_gl) / voc._hop)), 1)
            pred_mel = mel[:n_frames]
            _, wn_mel = spectrograms(wav, cfg)
            plot_mel_panel(os.path.join(args.out, f"e2e{i}_mels.png"),
                           [("Tacotron-2 predicted mel", pred_mel),
                            ("mel of WaveNet output", wn_mel)])
            e2e.append({
                "text": text,
                "wavenet_mel_l1_vs_predicted": round(mel_l1(wav, pred_mel, cfg), 4),
                "griffinlim_mel_l1_vs_predicted": round(
                    mel_l1(wav_gl, pred_mel, cfg), 4),
                "freq_track_agreement_wn_vs_gl": round(track_agreement(
                    dominant_freq_track(wav, sr),
                    dominant_freq_track(wav_gl, sr)), 4),
                "seconds": round(len(wav) / sr, 2),
            })
        report["end_to_end"] = e2e

    out_json = os.path.join(args.out, "report.json")
    with open(out_json, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    print("wrote", out_json)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
