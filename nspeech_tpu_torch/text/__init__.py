"""Text frontend: string -> symbol-id sequence.

``text_to_sequence`` with curly-brace ARPAbet escapes and EOS append, as in
the JAX package's ``nspeech_tpu/text/__init__.py``.
"""

from __future__ import annotations

import re
from typing import List

from nspeech_tpu_torch.text import cleaners as _cleaners_mod
from nspeech_tpu_torch.text.symbols import EOS, PAD, symbols

_symbol_to_id = {s: i for i, s in enumerate(symbols)}

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def text_to_sequence(text: str, cleaner_names: List[str]) -> List[int]:
    """Convert text to symbol ids. ``{HH AW1 S}``-style curly groups are
    treated as ARPAbet; EOS is appended."""
    sequence: List[int] = []
    while text:
        m = _curly_re.match(text)
        if not m:
            sequence.extend(_symbols_to_ids(_clean(text, cleaner_names)))
            break
        sequence.extend(_symbols_to_ids(_clean(m.group(1), cleaner_names)))
        sequence.extend(_arpabet_to_ids(m.group(2)))
        text = m.group(3)
    sequence.append(_symbol_to_id[EOS])
    return sequence


def _clean(text: str, cleaner_names: List[str]) -> str:
    for name in cleaner_names:
        cleaner = getattr(_cleaners_mod, name, None)
        if cleaner is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = cleaner(text)
    return text


def _symbols_to_ids(text: str) -> List[int]:
    return [_symbol_to_id[s] for s in text if _keep(s)]


def _arpabet_to_ids(text: str) -> List[int]:
    return [_symbol_to_id[s] for s in ("@" + p for p in text.split()) if _keep(s)]


def _keep(s: str) -> bool:
    return s in _symbol_to_id and s not in (PAD, EOS)
