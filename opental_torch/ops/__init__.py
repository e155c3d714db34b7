"""Device ops: boundary max pooling (CUDA kernel + plain version) and
soft-NMS."""
