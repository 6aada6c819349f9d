"""DataFeeder: python samples → feed dict of dense arrays (the port of
paddle_tpu/data/data_feeder.py; it returns numpy, and the Executor moves
the feed to the run's device).

reference: python/paddle/fluid/data_feeder.py — converts lists of sample
tuples to LoDTensors with lod construction.  Here ragged (lod_level=1)
slots are padded to the longest sequence in the batch (bucketed up to
`pad_to_multiple`, so a few shapes recur) and a `<name>.seq_len` int32
array carries the true lengths (SURVEY.md §5.7 segment-based design).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..core.program import Program, Variable


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None, program=None,
                 pad_to_multiple: int = 8):
        self.feed_vars: List[Variable] = []
        for v in feed_list:
            if isinstance(v, str):
                from ..core.program import default_main_program

                prog = program or default_main_program()
                v = prog.global_block().var(v)
            self.feed_vars.append(v)
        self.pad_to_multiple = pad_to_multiple

    def feed(self, iterable) -> Dict[str, np.ndarray]:
        """iterable: list of sample tuples aligned with feed_list."""
        rows = list(iterable)
        if not rows:
            raise ValueError("empty batch")
        out: Dict[str, np.ndarray] = {}
        for i, var in enumerate(self.feed_vars):
            column = [row[i] for row in rows]
            if var.lod_level > 1:
                padded, lens, lens2 = self._pad_nested(column, var)
                out[var.name] = padded
                out[f"{var.name}.seq_len"] = lens
                out[f"{var.name}.seq_len2"] = lens2
            elif var.lod_level > 0:
                padded, lens = self._pad(column, var)
                out[var.name] = padded
                out[f"{var.name}.seq_len"] = lens
            else:
                dtype = np.dtype(var.dtype)
                out[var.name] = np.asarray(column, dtype=dtype)
                want = var.shape
                got = out[var.name].shape
                if len(want) == len(got) + 1 and want[-1] == 1:
                    out[var.name] = out[var.name][..., None]
        return out

    def _bucket(self, observed_max: int, declared) -> int:
        """Round a batch's max length up to pad_to_multiple; a static
        declared dim wins (shared by the level-1 and level-2 paths)."""
        m = self.pad_to_multiple
        n = ((observed_max + m - 1) // m) * m
        if declared not in (None, -1, 0):
            return int(declared)
        return n

    def _pad(self, column, var):
        dtype = np.dtype(var.dtype)
        seqs = [np.asarray(s, dtype=dtype) for s in column]
        lens = np.asarray([len(s) for s in seqs], np.int32)
        max_len = self._bucket(
            int(lens.max()),
            var.shape[1] if len(var.shape) >= 2 else None)
        tail = seqs[0].shape[1:]
        padded = np.zeros((len(seqs), max_len) + tail, dtype=dtype)
        for i, s in enumerate(seqs):
            n = min(len(s), max_len)
            padded[i, :n] = s[:n]
        lens = np.minimum(lens, max_len)
        return padded, lens

    def _pad_nested(self, column, var):
        """Nested samples (lod_level=2): each sample is a list of
        sub-sequences; pad to (B, S1, S2, *tail) with level-1 lengths
        (B,) and level-2 lengths (B, S1).  Replaces the reference's
        two-level LoD offset tables (lod_tensor.h:76-104 validity)."""
        dtype = np.dtype(var.dtype)
        nested = [[np.asarray(sub, dtype=dtype) for sub in sample]
                  for sample in column]
        b = len(nested)
        lens1 = np.asarray([len(s) for s in nested], np.int32)
        s1 = self._bucket(
            int(lens1.max()),
            var.shape[1] if len(var.shape) >= 2 else None)
        all_subs = [sub for sample in nested for sub in sample]
        if not all_subs:
            raise ValueError("lod_level=2 batch has no sub-sequences")
        s2 = self._bucket(
            max(len(sub) for sub in all_subs),
            var.shape[2] if len(var.shape) >= 3 else None)
        # feature tail: the declared var shape is authoritative (an
        # empty first sub-sequence must not collapse it); fall back to
        # the first non-empty sub-sequence
        if len(var.shape) >= 4:
            tail = tuple(int(d) for d in var.shape[3:])
        else:
            non_empty = [s for s in all_subs if len(s)]
            tail = non_empty[0].shape[1:] if non_empty else ()
        padded = np.zeros((b, s1, s2) + tail, dtype=dtype)
        lens2 = np.zeros((b, s1), np.int32)
        for i, sample in enumerate(nested):
            for j, sub in enumerate(sample[:s1]):
                n = min(len(sub), s2)
                padded[i, j, :n] = sub[:n]
                lens2[i, j] = n
        lens1 = np.minimum(lens1, s1)
        return padded, lens1, lens2
