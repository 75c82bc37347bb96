"""Offline tools of the port (``python -m orbslam2_tpu_torch.tools.<name>``)."""
