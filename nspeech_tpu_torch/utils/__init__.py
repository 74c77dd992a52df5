"""Utilities: spectrogram images."""
