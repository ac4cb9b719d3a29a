"""Measurement tools of the port (run as ``python3 -m
maple_tpu_torch.tools.<name>``)."""
