"""Training: the CTC trainer, its optimizers and the shard pipeline."""
