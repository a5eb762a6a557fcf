"""Model layers of the PyTorch port (counterparts of `evo_tpu/layers`)."""
