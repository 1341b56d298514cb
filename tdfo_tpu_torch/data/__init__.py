"""Port of ``tdfo_tpu/data`` (see the package docstring)."""
