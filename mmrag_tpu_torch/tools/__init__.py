"""Measurement tools of the port (run as ``python -m mmrag_tpu_torch.tools.<name>``)."""
