"""Small shared helpers."""

from __future__ import annotations


def pad_bucket(n: int, minimum: int = 8) -> int:
    """Round up to the next power-of-two bucket (>= minimum): node
    slots, edge slots and SPF-root batches only change size when a
    bucket is outgrown."""
    cap = minimum
    while cap < n:
        cap <<= 1
    return cap
