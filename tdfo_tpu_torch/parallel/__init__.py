"""Port of ``tdfo_tpu/parallel`` (see the package docstring)."""
