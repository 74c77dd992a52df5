"""Run metadata persisted next to a checkpoint, from
``nspeech_tpu/train/metadata.py``: the same ``config.json`` schema and the
same override precedence, on the port's own :func:`load_config`.

The file holds the EFFECTIVE config of a run (after its startup mutations,
such as ``num_speakers``) and its speaker map, so serving builds from it
with no manual ``--hparams`` hand-off.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from nspeech_tpu_torch.config import Config, load_config

METADATA_FILE = "config.json"


def save_run_metadata(
    ckpt_dir: str,
    model_name: str,
    cfg: Config,
    speaker_map: Optional[Dict] = None,
) -> str:
    """Write ``config.json`` (atomically) into the checkpoint directory.

    ``speaker_map`` is the feeder's ``{(dataset, speaker): id}`` mapping;
    it is stored as a list of ``[dataset, speaker, id]`` rows.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    payload: Dict[str, Any] = {
        "model": model_name,
        "hparams": cfg.values(),
    }
    if speaker_map is not None:
        payload["speaker_map"] = [
            [ds, spk, idx] for (ds, spk), idx in sorted(
                speaker_map.items(), key=lambda kv: kv[1])
        ]
    path = os.path.join(ckpt_dir, METADATA_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, sort_keys=True, default=str)
    os.replace(tmp, path)
    return path


def load_run_metadata(ckpt_dir: str) -> Optional[Dict[str, Any]]:
    """Read ``config.json`` from a checkpoint directory, or None."""
    path = os.path.join(ckpt_dir, METADATA_FILE)
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def config_from_checkpoint(
    ckpt_dir: str,
    model_name: Optional[str] = None,
    overrides: str = "",
    default_model: Optional[str] = None,
) -> tuple[Config, str]:
    """Build the serving (Config, model_name) for a checkpoint.

    Prefers the persisted run metadata (exact training-time hparams, incl.
    the mutated ``num_speakers``); falls back to the defaults when the
    checkpoint has no metadata. Model-name precedence: explicit
    ``model_name`` > metadata > ``default_model`` (else raise). CLI
    ``overrides`` (``k=v,...``) are applied last either way.
    """
    from nspeech_tpu_torch.models import check_ported

    meta = load_run_metadata(ckpt_dir)
    name = model_name or (meta or {}).get("model") or default_model
    if name is None:
        raise ValueError(
            "Checkpoint %r has no run metadata (config.json); pass the "
            "model name explicitly" % ckpt_dir)
    check_ported(name)
    # Start from the CURRENT defaults and overlay the persisted hparams: a
    # key added after the checkpoint was trained keeps its default.
    cfg = load_config(name)
    if meta is not None:
        for key, value in meta["hparams"].items():
            setattr(cfg, key, value)
    cfg.parse(overrides)
    return cfg, name
