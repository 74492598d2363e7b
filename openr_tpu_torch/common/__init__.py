"""Shared constants and helpers of the PyTorch port."""
