"""Training: the Tacotron and WaveNet train steps, optimizer and
schedules, the training loop, checkpoints (training states and serving
archives) and run metadata."""

from nspeech_tpu_torch.train.checkpoint import (  # noqa: F401
    CheckpointManager,
    load_serving_params,
    save_serving_checkpoint,
)
from nspeech_tpu_torch.train.loop import (  # noqa: F401
    TrainState,
    build_tacotron_train_step,
    build_wavenet_train_step,
    create_state,
)
from nspeech_tpu_torch.train.metadata import (  # noqa: F401
    config_from_checkpoint,
    load_run_metadata,
    save_run_metadata,
)
from nspeech_tpu_torch.train.optim import make_optimizer, make_schedule  # noqa: F401
