"""Checkpoints and run metadata (training itself is not ported yet)."""

from nspeech_tpu_torch.train.checkpoint import (  # noqa: F401
    load_serving_params,
    save_serving_checkpoint,
)
from nspeech_tpu_torch.train.metadata import (  # noqa: F401
    config_from_checkpoint,
    load_run_metadata,
    save_run_metadata,
)
