"""Training losses (counterparts of `opental_tpu/losses/`)."""
