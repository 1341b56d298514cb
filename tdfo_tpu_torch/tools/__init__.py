"""Measurement tools of the port, run on a CUDA card (nothing here runs at
import time)."""
