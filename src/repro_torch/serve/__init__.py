"""Serving of the port: the batched engine and its latency calibration."""
