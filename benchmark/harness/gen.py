"""Traffic generation from a seed: texts, arrival times and clip lengths.

Every seed gets the same multiset of sizes and gaps in another order:
the target text lengths are the quantiles of a uniform distribution over
[lo, hi], the gaps between arrivals the quantiles of an exponential
distribution scaled to the window, and the clip durations the quantiles
of the corpus's distribution. So the amount of work is a property of the
cell, and a seed changes only which words are spoken, in which order the
requests come and the weights.

The word list is frozen here (common English words, without digits or
the abbreviations the cleaners expand), so the texts are the same in
every later version of the program."""

from __future__ import annotations

from typing import List

import numpy as np

WORDS = (
    "the of and to in is was for that with as on by at from his her they "
    "were had have this which been not but one all their there would more "
    "when about into them some could time these two may first then only "
    "other new like very after also over just many most must through back "
    "years where much your way well down should because each those people "
    "how too little state good very make world still own see men work long "
    "get here between both life being under never day same another know "
    "while last might great old year off come since against go came right "
    "used take three house small large place again around water found "
    "birch canoe slid smooth planks glue sheet dark blue background easy "
    "tell depth well days chicken leg rare dish rice often served round "
    "bowls juice lemons makes fine punch box thrown beside parked truck "
    "hogs fed chopped corn garbage four hours steady work faced us large "
    "size stockings hard sell boy ran across wide river clock struck noon "
    "steam rose from pot paint dried slowly window opened wind carried "
    "leaves garden bright morning quiet evening letter arrived early "
    "station crowded travellers reading papers table covered cloth green "
    "yellow stone wall bridge harbour ships sailed north south east west "
    "silver spoon kitchen drawer music played softly hall lamp burned low"
).split()


def _rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), sum(map(ord, stream))])


def uniform_quantiles(n: int, lo: float, hi: float) -> np.ndarray:
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


def text_of_length(rng: np.random.Generator, length: int) -> str:
    """A sentence of about ``length`` characters (never longer), words from
    :data:`WORDS`, a comma now and then, capitalised, ending with a
    period."""
    words: List[str] = []
    size = 0
    while True:
        w = WORDS[int(rng.integers(len(WORDS)))]
        add = len(w) + (1 if words else 0)
        if size + add + 1 > length:
            break
        if words and rng.random() < 0.08:
            words[-1] += ","
            size += 1
            if size + add + 1 > length:
                break
        words.append(w)
        size += add
    if not words:
        words = [WORDS[0]]
    s = " ".join(words).rstrip(",") + "."
    return s[0].upper() + s[1:]


def texts(seed: int, n: int, lo: int, hi: int) -> List[str]:
    """``n`` texts whose target lengths are the uniform quantiles over
    [lo, hi], in an order and with words drawn from ``seed``."""
    rng = _rng(seed, "texts")
    lengths = np.rint(uniform_quantiles(n, lo, hi)).astype(int)
    rng.shuffle(lengths)
    return [text_of_length(rng, int(L)) for L in lengths]


def arrivals(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Send times in [0, seconds) of an open loop at ``rate`` per second:
    n = floor(rate * seconds) gaps, the exponential quantiles scaled so
    that they fill the window, shuffled by ``seed``; the first request is
    sent at 0."""
    n = max(1, int(rate * seconds))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    gaps *= seconds / gaps.sum()
    _rng(seed, "arrivals").shuffle(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def durations(seed: int, n: int, lo: float, hi: float, mean: float) -> np.ndarray:
    """``n`` clip durations in [lo, hi] with the given mean: the quantiles
    of lo + (hi - lo) u^a with a = (hi - mean) / (mean - lo), shuffled."""
    a = (hi - mean) / (mean - lo)
    d = lo + (hi - lo) * uniform_quantiles(n, 0.0, 1.0) ** a
    _rng(seed, "durations").shuffle(d)
    return d


def check_sample(seed: int, texts, k: int) -> List[int]:
    """Indices of the ``k`` requests a run's comparison reads, drawn from
    ``seed``, with the longest text among them."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 77])
    k = min(int(k), len(texts))
    longest = int(np.argmax([len(t) for t in texts]))
    rest = [i for i in range(len(texts)) if i != longest]
    return sorted([longest] + [int(i) for i in rng.choice(rest, size=k - 1, replace=False)])
