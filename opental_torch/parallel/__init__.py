"""Data parallelism: one process per rank over `torch.distributed`."""
