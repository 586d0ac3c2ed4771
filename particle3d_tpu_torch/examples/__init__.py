"""Runnable examples of the port (``python -m particle3d_tpu_torch.examples.<name>``)."""
