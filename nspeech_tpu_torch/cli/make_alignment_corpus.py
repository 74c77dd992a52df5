"""Generate a synthetic-but-STRUCTURED corpus for alignment training.

    python -m nspeech_tpu_torch.cli.make_alignment_corpus <out_dir> \
        [n_utt] [seed] [style] [speakers]

The port's copy of the JAX package's ``scripts/make_alignment_corpus.py``,
on numpy and scipy alone, with its positional arguments and defaults: the
same arguments write the same bytes (WAVs and ``metadata.csv``).

Unlike ``tests/make_synth_corpus.py`` (whose audio is independent of the
text — fine for plumbing smoke tests, useless for attention), every
character here is rendered as a distinct spectral "phone":

- each character has its own base frequency and harmonic recipe, so the
  mel signature identifies the character;
- each instance's duration is jittered (0.75-1.3x the per-char base), so
  the text->audio time map is content-dependent and non-linear — the
  decoder can only predict the next frames by attending to the right
  input position, the monotonic-alignment problem real TTS training has
  to solve;
- words are drawn from a small lexicon (style ``words``) or are random
  letter strings (``chars``, ``formant``), lowercase with a final period,
  so ``english_cleaners`` is an identity and the 1:1 character<->audio
  correspondence survives the text frontend.

Output is LJSpeech layout (wavs/<id>.wav + metadata.csv), consumable by
``cli.train --ljspeech`` — or, with ``speakers > 1``, VCTK layout
(wav48/p<k>/..., txt/p<k>/...) for ``cli.train --vctk``: each speaker is
a distinct "voice" — a vocal-tract-length analog frequency scale plus a
harmonic tilt applied on top of the per-character recipe — so the model
can only hit the right absolute frequencies by using the speaker
embedding. ``--device`` is accepted as by every CLI of the port; the
audio is rendered on the host CPU whatever it names.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np

WORDS = [
    "tone", "line", "echo", "wave", "note", "drum", "reed", "bell",
    "hum", "air", "song", "beat", "chord", "pitch", "sound", "voice",
    "low", "high", "soft", "loud", "fast", "slow", "deep", "thin",
    "the", "a", "and", "of", "in", "on", "with", "over",
]

# Per-character base duration in seconds (vowels long, stops short).
_VOWELS = set("aeiou")


def _char_base_dur(c: str) -> float:
    if c == " ":
        return 0.06
    if c in _VOWELS:
        return 0.11
    if c in ",.?!":
        return 0.10
    return 0.075


def _char_freq(c: str) -> float:
    """Distinct base frequency per character: 170 Hz ('a') to 1.9 kHz
    ('z'), ~10% geometric spacing. Capped so the glide (up to 1.43x) and
    3rd harmonic stay below the 10 kHz Nyquist — aliased harmonics would
    fold onto other characters' bands and blur the fingerprints."""
    if c == " " or c in ",.?!":
        return 0.0  # rendered as silence/noise
    idx = ord(c) - ord("a")
    return 170.0 * (1900.0 / 170.0) ** (idx / 25.0)


def speaker_voice(k: int, n_speakers: int) -> tuple[float, float]:
    """(f_scale, h_tilt) for speaker k of n: frequency scales spread
    geometrically over [0.78, 1.2] (3rd harmonic x max glide x 1.2 stays
    under the 10 kHz Nyquist) and harmonic tilts over [0.5, 1.6], with
    the tilt ordering scrambled by a fixed seeded permutation — valid
    for ANY n (a modular-multiplier scramble degenerates whenever n
    shares a factor with the multiplier)."""
    if n_speakers <= 1:
        return 1.0, 1.0
    u = k / (n_speakers - 1)
    t = int(_tilt_perm(n_speakers)[k]) / (n_speakers - 1)
    return 0.78 * (1.2 / 0.78) ** u, 0.5 * (1.6 / 0.5) ** t


@functools.lru_cache(maxsize=None)
def _tilt_perm(n_speakers: int):
    return tuple(np.random.default_rng(97).permutation(n_speakers))


def render_char(c: str, dur: float, sample_rate: int,
                rng: np.random.Generator, f_scale: float = 1.0,
                h_tilt: float = 1.0) -> np.ndarray:
    """Render one character as a NONSTATIONARY tone.

    A constant tone is predictable from its own previous frames, which
    lets a decoder drive its loss down with diffuse attention (observed:
    loss 0.05 with near-uniform alignments). Every frame here depends on
    character identity instead: the fundamental GLIDES (char-specific
    direction/rate, so continuation requires knowing which char this is)
    under a char-specific tremolo, on top of the char-specific harmonic
    recipe.
    """
    n = int(dur * sample_rate)
    t = np.arange(n) / sample_rate
    f = _char_freq(c)
    if f == 0.0:
        return 0.004 * rng.standard_normal(n)
    idx = ord(c) - ord("a")
    # exponential glide f(t) = f * g^(t/dur); g in [0.7, 1.43], char-specific
    g = 0.7 * (1.43 / 0.7) ** (((idx * 11) % 26) / 25.0)
    inst_f = f * f_scale * g ** (t / max(dur, 1e-6))
    phase = 2 * np.pi * np.cumsum(inst_f) / sample_rate
    # character-specific harmonic recipe (second fingerprint besides f0),
    # scaled by the speaker's harmonic tilt
    h2 = h_tilt * 0.5 * ((idx * 7) % 5) / 4.0
    h3 = h_tilt * 0.5 * ((idx * 3) % 5) / 4.0
    wav = np.sin(phase) + h2 * np.sin(2 * phase) + h3 * np.sin(3 * phase)
    # char-specific tremolo (4-12 Hz amplitude modulation)
    trem = 4.0 + 8.0 * (((idx * 5) % 13) / 12.0)
    am = 1.0 - 0.35 * np.sin(2 * np.pi * trem * t)
    # attack/release ramps to avoid clicks and give an onset cue
    ramp = min(n // 8, int(0.008 * sample_rate)) or 1
    env = np.ones(n)
    env[:ramp] = np.linspace(0, 1, ramp)
    env[-ramp:] = np.linspace(1, 0, ramp)
    wav = 0.4 * wav / (1.0 + h2 + h3) * am * env
    return wav + 0.003 * rng.standard_normal(n)


# --- formant style: speech-LIKE phones instead of chirped tones -------------
#
# Each character still has a unique, learnable acoustic fingerprint (the
# alignment-learnability requirement), but the signal class matches real
# speech: a harmonic glottal source under a two-formant spectral
# envelope for vowels and voiced consonants, band-limited noise
# fricatives and stop bursts for unvoiced consonants, and a sentence-
# level F0 declination — so the mels the model learns on carry formant
# structure, wideband noise, and transients rather than pure tones.

_UNVOICED = set("ptkfsh")
_VOWEL_FORMANTS = {  # (F1, F2) Hz — spread across the vowel space
    "a": (800, 1200), "e": (550, 1900), "i": (300, 2300),
    "o": (500, 900), "u": (320, 750),
}


def _consonant_formants(c: str) -> tuple[float, float]:
    """Distinct (F1, F2) per voiced consonant, spread geometrically and
    decorrelated by coprime strides so no two consonants share a pair."""
    idx = ord(c) - ord("a")
    f1 = 250.0 * (900.0 / 250.0) ** (((idx * 7) % 21) / 20.0)
    f2 = 900.0 * (2400.0 / 900.0) ** (((idx * 11) % 21) / 20.0)
    return f1, f2


def render_char_formant(c: str, dur: float, sample_rate: int,
                        rng: np.random.Generator, pos01: float = 0.0,
                        f_scale: float = 1.0,
                        h_tilt: float = 1.0) -> np.ndarray:
    """Render one character as a speech-like phone.

    Voiced phones: harmonics of a declining F0 weighted by a
    char-specific two-formant envelope (vocal-tract analog; the
    speaker's ``f_scale`` shifts the formants — vocal-tract length —
    and ``h_tilt`` tilts the source spectrum). Unvoiced consonants:
    char-band-filtered noise, with a stop-like silence+burst onset for
    p/t/k. ``pos01`` is the character's position in the sentence (0..1)
    driving the F0 declination — prosody the decoder must carry across
    the utterance."""
    n = int(dur * sample_rate)
    t = np.arange(n) / sample_rate
    if c == " ":
        return 0.002 * rng.standard_normal(n)
    if c in ",.?!":
        return 0.002 * rng.standard_normal(n)
    idx = ord(c) - ord("a")
    ramp = min(n // 8, int(0.008 * sample_rate)) or 1
    env = np.ones(n)
    env[:ramp] = np.linspace(0, 1, ramp)
    env[-ramp:] = np.linspace(1, 0, ramp)

    if c in _UNVOICED:
        # fricative: noise through a char-specific band (one-pole-ish
        # shaping via FFT mask — cheap and deterministic)
        center = 1500.0 * (6000.0 / 1500.0) ** (((idx * 5) % 6) / 5.0)
        width = 0.35 * center
        noise = rng.standard_normal(n)
        spec = np.fft.rfft(noise)
        freqs = np.fft.rfftfreq(n, 1.0 / sample_rate)
        spec *= np.exp(-0.5 * ((freqs - center * f_scale) / width) ** 2)
        wav = np.fft.irfft(spec, n)
        wav = 0.35 * wav / (np.abs(wav).max() + 1e-6)
        if c in "ptk":
            # stop: closure silence then a burst transient
            gate = np.zeros(n)
            burst = max(int(0.25 * n), 1)
            gate[-burst:] = np.linspace(1.0, 0.3, burst)
            wav = wav * gate * 1.6
        return wav * env + 0.003 * rng.standard_normal(n)

    # voiced: F0 declines over the sentence (prosody), slight vibrato
    f0 = 175.0 * (0.72 ** pos01) * (1.0 + 0.015 * np.sin(2 * np.pi * 5 * t))
    phase0 = 2 * np.pi * np.cumsum(f0) / sample_rate
    if c in _VOWEL_FORMANTS:
        f1, f2 = _VOWEL_FORMANTS[c]
    else:
        f1, f2 = _consonant_formants(c)
        env = env * (0.55 if c in "bdg" else 0.8)   # weaker than vowels
    f1, f2 = f1 * f_scale, f2 * f_scale
    wav = np.zeros(n)
    base_f0 = 175.0 * 0.72 ** pos01
    n_harm = int(min(22, (sample_rate / 2 - 200) // base_f0))
    for k in range(1, n_harm + 1):
        fk = k * base_f0
        # two-formant envelope + source tilt (h_tilt > 1 = brighter)
        a = (np.exp(-0.5 * ((fk - f1) / (0.25 * f1 + 60)) ** 2)
             + 0.7 * np.exp(-0.5 * ((fk - f2) / (0.20 * f2 + 80)) ** 2)
             + 0.03)
        a *= (k ** (-1.0 / max(h_tilt, 1e-3)))
        wav += a * np.sin(k * phase0)
    wav = 0.45 * wav / (np.abs(wav).max() + 1e-6)
    return wav * env + 0.003 * rng.standard_normal(n)


def render_text(text: str, sample_rate: int, rng: np.random.Generator,
                f_scale: float = 1.0, h_tilt: float = 1.0,
                style: str = "words") -> np.ndarray:
    if style == "formant":
        L = max(len(text) - 1, 1)
        parts = [
            render_char_formant(c, _char_base_dur(c) * rng.uniform(0.75, 1.3),
                                sample_rate, rng, pos01=i / L,
                                f_scale=f_scale, h_tilt=h_tilt)
            for i, c in enumerate(text)
        ]
    else:
        parts = [
            render_char(c, _char_base_dur(c) * rng.uniform(0.75, 1.3),
                        sample_rate, rng, f_scale=f_scale, h_tilt=h_tilt)
            for c in text
        ]
    return np.clip(np.concatenate(parts), -1.0, 1.0)


def make_sentence(rng: np.random.Generator, style: str = "words") -> str:
    """``words``: sentences from the 32-word lexicon. ``chars``: RANDOM
    letter strings — maximum text entropy (~4.7 bits/char), so a long
    utterance cannot fit through the encoder's fixed-width final states
    and per-step attention is the only way to know what to say next (the
    lexicon corpus was observed to train a summary-token shortcut: sharp
    attention parked on the last encoder positions)."""
    if style in ("chars", "formant"):  # formant keeps high-entropy text
        n_words = int(rng.integers(8, 14))
        words = ["".join(chr(ord("a") + int(rng.integers(0, 26)))
                         for _ in range(int(rng.integers(2, 7))))
                 for _ in range(n_words)]
    else:
        n_words = int(rng.integers(3, 9))
        words = [WORDS[int(rng.integers(0, len(WORDS)))]
                 for _ in range(n_words)]
    return " ".join(words) + "."


def make_corpus(out_dir: str, n: int = 400, sample_rate: int = 20000,
                seed: int = 11, style: str = "words",
                speakers: int = 1) -> str:
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    lines = []
    total_s = 0.0
    if speakers <= 1:
        os.makedirs(os.path.join(out_dir, "wavs"), exist_ok=True)
    for i in range(n):
        text = make_sentence(rng, style)
        if speakers > 1:
            # VCTK layout, speakers round-robin so every speaker sees the
            # same amount of (different) text
            spk = i % speakers
            f_scale, h_tilt = speaker_voice(spk, speakers)
            wav = render_text(text, sample_rate, rng,
                              f_scale=f_scale, h_tilt=h_tilt, style=style)
            base = "p%03d_%04d" % (spk + 1, i)
            wav_dir = os.path.join(out_dir, "wav48", "p%03d" % (spk + 1))
            txt_dir = os.path.join(out_dir, "txt", "p%03d" % (spk + 1))
            os.makedirs(wav_dir, exist_ok=True)
            os.makedirs(txt_dir, exist_ok=True)
            wavfile.write(os.path.join(wav_dir, base + ".wav"),
                          sample_rate, (wav * 32767).astype(np.int16))
            with open(os.path.join(txt_dir, base + ".txt"), "w",
                      encoding="utf-8") as f:
                f.write(text + "\n")
        else:
            utt_id = "ALN%04d" % i
            wav = render_text(text, sample_rate, rng, style=style)
            wavfile.write(os.path.join(out_dir, "wavs", utt_id + ".wav"),
                          sample_rate, (wav * 32767).astype(np.int16))
            lines.append(f"{utt_id}|{text}|{text}")
        total_s += len(wav) / sample_rate
    if lines:
        with open(os.path.join(out_dir, "metadata.csv"), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    print("Wrote %d utterances (%.1f min of audio, %d speaker(s)) to %s"
          % (n, total_s / 60.0, max(speakers, 1), out_dir))
    return out_dir


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out_dir", nargs="?", default="/tmp/alignment_corpus")
    p.add_argument("n_utt", nargs="?", type=int, default=400)
    p.add_argument("seed", nargs="?", type=int, default=11)
    p.add_argument("style", nargs="?", default="words",
                   choices=["words", "chars", "formant"])
    p.add_argument("speakers", nargs="?", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="accepted for the CLIs' common interface; the corpus "
                        "is rendered with numpy on the host")
    args = p.parse_args(argv)
    make_corpus(args.out_dir, args.n_utt, seed=args.seed, style=args.style,
                speakers=args.speakers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
