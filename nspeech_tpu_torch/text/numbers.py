"""Number-to-words normalization for English text.

Behavioral rebuild of the reference's inflect-based normalizer
(reference: neural_speech/utils/text/numbers.py): comma removal, pound/dollar
amounts, decimal points, ordinals, and year-style reading of 1001-2999.
Implemented from scratch (the inflect package is not a dependency here).
"""

from __future__ import annotations

import re

_comma_number_re = re.compile(r"([0-9][0-9,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9.,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [
    "", "thousand", "million", "billion", "trillion", "quadrillion",
    "quintillion", "sextillion", "septillion", "octillion", "nonillion",
    "decillion",
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def _three_digits(n: int, andword: str) -> str:
    hundreds, rem = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_ONES[hundreds] + " hundred")
    if rem:
        if hundreds and andword:
            parts.append(andword)
        parts.append(_two_digits(rem))
    return " ".join(parts)


def number_to_words(n: int, andword: str = "and", zero: str = "zero",
                    group: int = 0) -> str:
    """Spell out an integer.

    ``group=2`` reads the number in two-digit groups (year style), with
    ``zero`` used for a leading 0 in a group — e.g. 1901 -> "nineteen oh one".
    """
    if n < 0:
        return "minus " + number_to_words(-n, andword=andword, zero=zero, group=group)
    if group == 2:
        digits = str(n)
        if len(digits) % 2 == 1:
            digits = "0" + digits
        words = []
        for i in range(0, len(digits), 2):
            pair = int(digits[i:i + 2])
            if pair == 0:
                words.append(f"{zero} {zero}")
            elif pair < 10 and digits[i] == "0":
                words.append(f"{zero} {_ONES[pair]}")
            else:
                words.append(_two_digits(pair))
        return " ".join(words)
    if n == 0:
        return zero
    # Split into scale groups of three digits.
    digits = str(n)
    groups = []
    while n > 0:
        n, rem = divmod(n, 1000)
        groups.append(rem)
    if len(groups) > len(_SCALES):
        # Beyond named scales: read digit by digit.
        return " ".join(_ONES[int(d)] for d in digits)
    parts = []
    for idx in range(len(groups) - 1, -1, -1):
        g = groups[idx]
        if g == 0:
            continue
        words = _three_digits(g, andword)
        if _SCALES[idx]:
            words += " " + _SCALES[idx]
        parts.append(words)
    return ", ".join(parts)


def ordinal_to_words(n: int) -> str:
    """Spell out an ordinal, e.g. 21 -> "twenty-first"."""
    cardinal = number_to_words(n)
    # Transform the final word.
    for sep in (" ", "-"):
        idx = cardinal.rfind(sep)
        if idx >= 0:
            head, last = cardinal[: idx + 1], cardinal[idx + 1:]
            break
    else:
        head, last = "", cardinal
    if last in _ORDINAL_IRREGULAR:
        return head + _ORDINAL_IRREGULAR[last]
    if last.endswith("y"):
        return head + last[:-1] + "ieth"
    return head + last + "th"


def _remove_commas(m: re.Match) -> str:
    return m.group(1).replace(",", "")


def _expand_decimal_point(m: re.Match) -> str:
    return m.group(1).replace(".", " point ")


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"  # unexpected format, leave digits
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_ordinal(m: re.Match) -> str:
    return ordinal_to_words(int(m.group(0)[:-2]))


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        # Year-style reading (reference: numbers.py:47-57).
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100, andword="")
        if num % 100 == 0:
            return number_to_words(num // 100, andword="") + " hundred"
        return number_to_words(num, andword="", zero="oh", group=2)
    return number_to_words(num, andword="")


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(_remove_commas, text)
    text = _pounds_re.sub(r"\1 pounds", text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_number_re.sub(_expand_decimal_point, text)
    text = _ordinal_re.sub(_expand_ordinal, text)
    text = _number_re.sub(_expand_number, text)
    return text
