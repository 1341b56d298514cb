"""Port of ``tdfo_tpu/utils`` (see the package docstring)."""
