"""Observability of the PyTorch port (counterpart of `ray_tpu.observability`)."""
