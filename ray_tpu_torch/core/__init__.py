"""Configuration of the PyTorch port (counterpart of `ray_tpu.core`)."""
