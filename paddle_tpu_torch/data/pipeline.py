"""Host-side feed admission: the part of paddle_tpu/data/pipeline.py
that `contrib.Trainer(validate_feed=True)` uses (its :40-80).

`DeviceFeeder` and `PyReader` (the double-buffered host→device
prefetch) are not ported yet: ROADMAP queue A step 12.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def feed_signature(batch: Dict[str, Any]) -> Dict[str, Tuple[str, int]]:
    """The per-feed (dtype, ndim) signature validation locks onto
    after the first accepted batch (in the reference a drift would
    retrace the jitted step; in the port it would feed the step a batch
    of another kind than every batch before it)."""
    return {n: (str(np.asarray(v).dtype), int(np.asarray(v).ndim))
            for n, v in batch.items()}


def validate_feed_batch(batch: Dict[str, Any],
                        signature: Optional[Dict[str, Tuple[str, int]]]
                        = None) -> List[Dict[str, Any]]:
    """Host-side admission check of a batch of host arrays
    (Trainer(validate_feed=True)): every float feed must be finite,
    and (with a locked signature) dtypes/ndims must match the first
    accepted batch.  Returns a list of structured problems (empty =
    admit) — the payload of the `feed_quarantined` event."""
    problems: List[Dict[str, Any]] = []
    for name, v in batch.items():
        arr = np.asarray(v)
        if np.issubdtype(arr.dtype, np.floating):
            finite = np.isfinite(arr)
            if not finite.all():
                problems.append(
                    {"name": name, "problem": "nonfinite",
                     "bad_values": int(arr.size - int(finite.sum()))})
        if signature is not None:
            want = signature.get(name)
            got = (str(arr.dtype), int(arr.ndim))
            if want is None:
                problems.append({"name": name,
                                 "problem": "unknown_feed"})
            elif want != got:
                problems.append({"name": name,
                                 "problem": "signature_drift",
                                 "want": list(want),
                                 "got": list(got)})
    if signature is not None:
        for name in sorted(set(signature) - set(batch)):
            problems.append({"name": name, "problem": "missing_feed"})
    return problems
