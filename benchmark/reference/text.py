"""Text to symbol ids for the benchmark's texts.

The symbol table of the reference recipe (pad, EOS, 63 characters, 84
ARPAbet phones) and the English cleaners reduced to what the benchmark's
generator can produce: ASCII letters, spaces, commas and periods. Any
other character raises, so a generator that grows past this alphabet
fails loudly instead of being compared wrongly."""

from __future__ import annotations

import re
from typing import List

PAD_ID, EOS_ID = 0, 1
CHARACTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!'(),-.:;? "
N_ARPABET = 84
VOCAB = 2 + len(CHARACTERS) + N_ARPABET     # 149 rows of the embedding

_ALLOWED = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ ,.")
_ID = {c: 2 + i for i, c in enumerate(CHARACTERS)}
_SPACES = re.compile(r"\s+")


def to_ids(text: str) -> List[int]:
    """Lowercase, collapse whitespace, one id per character, then EOS."""
    bad = set(text) - _ALLOWED
    if bad:
        raise ValueError(f"reference text frontend: characters {sorted(bad)} "
                         "are outside the benchmark's alphabet")
    return [_ID[c] for c in _SPACES.sub(" ", text.lower())] + [EOS_ID]


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple
