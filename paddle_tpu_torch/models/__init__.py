"""Model builders ported from paddle_tpu/models."""

from .machine_translation import beam_search_net, seq_to_seq_net  # noqa: F401
