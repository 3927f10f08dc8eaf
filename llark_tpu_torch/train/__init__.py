"""Training: optimizer, train step, state, checkpoints, tracking and the trainer."""
