"""Data: corpus loaders, per-utterance features and their cache, and the
Tacotron data feeder."""
