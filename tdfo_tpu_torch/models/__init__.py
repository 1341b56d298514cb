"""Port of ``tdfo_tpu/models`` (see the package docstring)."""
