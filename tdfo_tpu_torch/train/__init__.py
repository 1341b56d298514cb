"""Port of ``tdfo_tpu/train`` (see the package docstring)."""
