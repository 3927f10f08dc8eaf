"""Audio I/O and the mel-spectrogram frontend (counterpart of llark_tpu/audio/)."""
