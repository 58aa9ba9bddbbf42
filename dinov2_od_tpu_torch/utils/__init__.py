"""Measurement helpers of the port: timing and tracing on the card."""
