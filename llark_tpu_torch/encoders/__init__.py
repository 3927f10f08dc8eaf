"""Audio encoders: WAV -> the embeddings LLark reads (counterpart of llark_tpu/encoders/)."""
