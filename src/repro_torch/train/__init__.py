"""Training: the loss, the train step, the trainer and its checkpoints."""
