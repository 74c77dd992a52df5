"""Serving: text -> (Tacotron) mel -> (WaveNet | Griffin-Lim) waveform,
one-shot or streamed, one request at a time or batched, live or from an
exported artifact.

The names load on first use, so that a loader of exported artifacts
(``serving/export.py``) imports no model code."""

import importlib

_NAMES = {
    "DynamicBatcher": "batcher", "StreamBatcher": "batcher",
    "ClientError": "errors",
    "ExportedSynthesizer": "export", "ExportedVocoder": "export",
    "split_text": "longform", "synthesize_long": "longform",
    "TextToSpeech": "pipeline", "WaveNetVocoder": "pipeline",
    "StreamingTTS": "streaming",
    "Synthesizer": "synthesizer",
}

__all__ = sorted(_NAMES)


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_NAMES[name]}"), name)
