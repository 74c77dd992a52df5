"""Corpus loaders: a copy of ``nspeech_tpu/data/corpus.py``.

Each loader yields ``(wav_path, text, local_speaker_id, dataset_id)``
tuples from one on-disk layout (LJSpeech, VCTK, a LibriSpeech-style
``corpus.csv``, CMU Arctic); the speaker map is sorted, so every process
computes the same ids.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Callable, Dict, Iterator, Tuple

Item = Tuple[str, str, object, str]


def load_ljspeech(in_dir: str) -> Iterator[Item]:
    """LJSpeech layout: metadata.csv with pipe-separated
    ``id|raw_text|normalized_text`` rows and wavs/<id>.wav files."""
    with open(os.path.join(in_dir, "metadata.csv"), encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) < 3:
                continue
            wav_path = os.path.join(in_dir, "wavs", "%s.wav" % parts[0])
            yield wav_path, parts[2], 0, "ljspeech"


_vctk_speaker_re = re.compile(r"p([0-9]+)_")


def load_vctk(in_dir: str) -> Iterator[Item]:
    """VCTK layout: wav48/p<speaker>/<utt>.wav with parallel txt/ files."""
    for wav_path in sorted(glob.glob("%s/wav48/p*/*.wav" % in_dir)):
        text_path = wav_path.replace("wav48", "txt").replace("wav", "txt")
        if not os.path.isfile(text_path):
            continue
        with open(text_path, "r", encoding="utf-8") as f:
            text = f.read().strip()
        name = os.path.splitext(os.path.basename(wav_path))[0]
        m = _vctk_speaker_re.match(name)
        if not m:
            continue
        yield wav_path, text, m.group(1), "vctk"


def load_librispeech(in_dir: str) -> Iterator[Item]:
    """LibriSpeech-style corpus.csv: ``id,relpath,text,mode`` rows where the
    id encodes ``speaker-chapter-utterance``."""
    with open(os.path.join(in_dir, "corpus.csv"), encoding="utf-8") as f:
        for line in f:
            identifier, path, text, _mode = line.strip().split(",")
            speaker_id = identifier.split("-")[0]
            yield os.path.join(in_dir, path), text, speaker_id, "libre"


_arctic_line_re = re.compile(r'\(\s*(\S+)\s+"(.*)"\s*\)')


def load_arctic(in_dir: str) -> Iterator[Item]:
    """CMU Arctic layout (as fetched by the reference's
    scripts/download_arctic.sh): ``cmu_us_<speaker>_arctic/`` directories
    each holding ``wav/*.wav`` and a festival-format ``etc/txt.done.data``
    prompt list ``( arctic_a0001 "text" )``."""
    for spk_dir in sorted(glob.glob(os.path.join(in_dir, "cmu_us_*_arctic"))):
        m = re.search(r"cmu_us_(\w+)_arctic", os.path.basename(spk_dir))
        if not m:
            continue
        speaker = m.group(1)
        prompts = os.path.join(spk_dir, "etc", "txt.done.data")
        if not os.path.isfile(prompts):
            continue
        with open(prompts, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                pm = _arctic_line_re.match(line.strip())
                if not pm:
                    continue
                utt_id, text = pm.group(1), pm.group(2)
                wav_path = os.path.join(spk_dir, "wav", utt_id + ".wav")
                if os.path.isfile(wav_path):
                    yield wav_path, text, speaker, "arctic"


LOADERS: Dict[str, Callable[[str], Iterator[Item]]] = {
    "ljspeech": load_ljspeech,
    "vctk": load_vctk,
    "librispeech": load_librispeech,
    "arctic": load_arctic,
}


def load_items(input_paths: Dict[str, str]) -> list[Item]:
    """Gather items from every (corpus_name -> directory) entry."""
    items: list[Item] = []
    for name, path in input_paths.items():
        if name not in LOADERS:
            raise ValueError(f"Unknown corpus type {name!r}; known: {sorted(LOADERS)}")
        items.extend(LOADERS[name](path))
    if not items:
        raise ValueError("No data found in %r" % (input_paths,))
    return items


def build_speaker_map(items: list[Item]) -> Dict[Tuple[str, object], int]:
    """Deterministic global speaker ids.

    Unlike the reference (which enumerates an unordered set and persists it
    to a hardcoded /cache path, datafeeder.py:56-60), the mapping here is
    sorted so every host computes the same ids with no shared file.
    """
    speakers = sorted({(ds, str(spk)) for (_, _, spk, ds) in items})
    return {key: i for i, key in enumerate(speakers)}
