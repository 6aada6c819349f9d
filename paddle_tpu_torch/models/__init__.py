"""Model builders ported from paddle_tpu/models."""
