"""Layered configuration: audio < train < model, plus ``k=v,...`` overrides.

Port of ``nspeech_tpu/config.py`` with the YAML files replaced by the dicts
of :mod:`nspeech_tpu_torch.hparams`.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Dict

from nspeech_tpu_torch import hparams as _hp


class Config:
    """Attribute-accessible hyperparameter bag; ``parse("k=v,...")``
    overrides, unknown keys raise."""

    def __init__(self, values: Dict[str, Any]):
        object.__setattr__(self, "_values", dict(values))

    def __getattr__(self, name: str) -> Any:
        if name == "_values":
            raise AttributeError(name)
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(f"Unknown hparam: {name!r}") from None

    def __setattr__(self, name: str, value: Any) -> None:
        self._values[name] = value

    def get(self, name: str, default: Any = None) -> Any:
        return self._values.get(name, default)

    def values(self) -> Dict[str, Any]:
        return dict(self._values)

    def parse(self, override_string: str) -> "Config":
        """Apply ``k=v,...`` overrides in place (values parsed as Python
        literals when possible, strings otherwise)."""
        if not override_string:
            return self
        for item in override_string.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(f"Bad hparam override (need k=v): {item!r}")
            key, raw = item.split("=", 1)
            key = key.strip()
            if key not in self._values:
                raise ValueError(f"Unknown hparam in override: {key!r}")
            try:
                value = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                value = raw
            self._values[key] = value
        return self

    def __repr__(self) -> str:
        return f"Config({self._values!r})"


def load_config(model_type: str) -> Config:
    """Merge audio + train + <model_type> hparams into a Config."""
    if model_type not in _hp.MODELS:
        raise ValueError(f"Unknown model: {model_type} "
                         f"(known: {sorted(_hp.MODELS)})")
    merged = copy.deepcopy(_hp.AUDIO)
    merged.update(copy.deepcopy(_hp.TRAIN))
    merged.update(copy.deepcopy(_hp.MODELS[model_type]))
    return Config(merged)


def stft_params(cfg: Config) -> tuple[int, int, int]:
    """(n_fft, hop_length, win_length)."""
    n_fft = (cfg.num_freq - 1) * 2
    hop_length = int(cfg.frame_shift_ms / 1000 * cfg.sample_rate)
    win_length = int(cfg.frame_length_ms / 1000 * cfg.sample_rate)
    return n_fft, hop_length, win_length


def debug_string(cfg: Config) -> str:
    """The hparams, one ``  name: value`` line each, sorted by name."""
    values = cfg.values()
    return "Hyperparameters:\n" + "\n".join(
        "  %s: %s" % (name, values[name]) for name in sorted(values))
