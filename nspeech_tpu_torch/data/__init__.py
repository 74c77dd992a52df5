"""Data: corpus loaders, per-utterance features and their cache, the
Tacotron data feeder and its device-resident batch cache, the WaveNet
window feeder, and the GTA mel export."""
