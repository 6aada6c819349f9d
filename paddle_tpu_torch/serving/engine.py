"""The shape-bucket ladder helpers of paddle_tpu/serving/engine.py
`BucketConfig` that the decode engine uses (the dynamic-batching
`ServingEngine` itself is not ported yet: ROADMAP queue A item 7)."""

from __future__ import annotations

from typing import Optional, Tuple


class BucketConfig:
    """Bucket-ladder validation and selection."""

    @staticmethod
    def _ladder(name: str, vals) -> Tuple[int, ...]:
        vals = tuple(int(v) for v in vals)
        if not vals or any(v < 1 for v in vals) \
                or list(vals) != sorted(set(vals)):
            raise ValueError(
                f"{name} must be ascending unique positive ints, "
                f"got {vals}")
        return vals

    @staticmethod
    def pick(ladder: Tuple[int, ...], need: int) -> Optional[int]:
        """Smallest bucket >= need (minimum padding waste), or None."""
        for v in ladder:
            if v >= need:
                return v
        return None
