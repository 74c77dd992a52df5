"""Text cleaners.

Same cleaner inventory and composition as the reference
(reference: neural_speech/utils/text/cleaners.py): english_cleaners,
transliteration_cleaners, basic_cleaners plus the individual passes.
ASCII transliteration is built on stdlib unicodedata (NFKD decomposition)
with a supplementary map for characters NFKD cannot decompose, instead of
the unidecode dependency.
"""

from __future__ import annotations

import re
import unicodedata

from nspeech_tpu_torch.text.numbers import normalize_numbers

_whitespace_re = re.compile(r"\s+")

_abbreviations = [
    (re.compile(r"\b%s\." % abbr, re.IGNORECASE), expansion)
    for abbr, expansion in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]

# Characters NFKD leaves intact; mapped by hand (quotes, dashes, ligatures,
# and letters with no decomposition).
_ASCII_MAP = {
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "“": '"', "”": '"', "„": '"',
    "–": "-", "—": "-", "―": "-", "−": "-",
    "…": "...",
    "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE",
    "ß": "ss", "ẞ": "SS",
    "ø": "o", "Ø": "O", "ł": "l", "Ł": "L",
    "ð": "d", "Ð": "D", "þ": "th", "Þ": "Th",
    "¡": "!", "¿": "?",
    "·": "-", "•": "-",
    "«": '"', "»": '"', "‹": "'", "›": "'",
    " ": " ",
}


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = regex.sub(replacement, text)
    return text


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(" ", text)


def convert_to_ascii(text: str) -> str:
    text = "".join(_ASCII_MAP.get(ch, ch) for ch in text)
    decomposed = unicodedata.normalize("NFKD", text)
    return decomposed.encode("ascii", "ignore").decode("ascii")


def basic_cleaners(text: str) -> str:
    """Lowercase + whitespace collapse, no transliteration."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    """ASCII transliteration for non-English text."""
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    """Full English pipeline: transliterate, lowercase, expand numbers and
    abbreviations, collapse whitespace."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text
