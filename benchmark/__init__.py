"""The benchmark of nspeech_tpu_torch (see README.md)."""
