"""Port of ``tdfo_tpu/core`` (see the package docstring)."""
