"""The port's command-line examples (``python -m orbslam2_tpu_torch.examples.<name>``):
the dataset runner, the evaluation harness, timestamp association and
vocabulary training from a saved map."""
