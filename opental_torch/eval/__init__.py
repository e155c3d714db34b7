"""Detection evaluation (jax-free copies of `opental_tpu/eval`)."""
