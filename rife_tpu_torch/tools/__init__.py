"""Measurement tools of the port, run as `python -m rife_tpu_torch.tools.<name>`."""
