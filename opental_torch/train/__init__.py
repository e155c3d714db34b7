"""Training: step, checkpoints and the epoch loop (counterparts of
`opental_tpu/train/`)."""
