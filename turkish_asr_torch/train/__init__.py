"""CTC training: optimizer and schedule, checkpoints, the trainer."""
