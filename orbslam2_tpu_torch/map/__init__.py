"""Map state (port of orbslam2_tpu.map)."""
