"""Serving-side data helpers of the port: WAV I/O and the eval pipeline."""
