"""Port of ``tdfo_tpu/ops`` (see the package docstring)."""
