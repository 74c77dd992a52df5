"""Import of the reference framework's (TensorFlow) checkpoints into the
port: a copy of the JAX package's ``nspeech_tpu/migrate``, host numpy only.

``tfbundle``  — from-spec TensorFlow V2 checkpoint reader (no TF import).
``reference`` — reference-WaveNet variable-name mapping -> the param tree.
``tacotron``  — reference Tacotron-1/2 mapping -> params and batch-norm state.

CLI entry point: ``python -m nspeech_tpu_torch.cli.import_reference_ckpt``
converts a ``tf.train.Saver`` checkpoint into the port's serving
checkpoint.
"""

from nspeech_tpu_torch.migrate.tfbundle import BundleError, TFBundleReader
from nspeech_tpu_torch.migrate.reference import (check_dilations, import_wavenet,
                                                 ImportError_)
from nspeech_tpu_torch.migrate.tacotron import detect_model, import_tacotron

__all__ = ["BundleError", "TFBundleReader", "check_dilations",
           "detect_model", "import_tacotron", "import_wavenet", "ImportError_"]
