"""Batched algorithm ops (PyTorch port of orbslam2_tpu.ops)."""
