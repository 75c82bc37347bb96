"""Camera models (PyTorch port of orbslam2_tpu.models)."""
