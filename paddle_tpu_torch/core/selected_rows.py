"""SparseGrad: the gradient of an embedding table as touched rows.

The port of paddle_tpu/core/selected_rows.py (reference:
paddle/fluid/framework/selected_rows.h:32 — a rows-index + value-tensor
pair produced by the embedding backward and consumed by the optimizers'
sparse update kernels, math/selected_rows_functor.h).

A `lookup_table` op with is_sparse=True makes the Executor differentiate
with respect to the gathered rows instead of the whole table
(core/executor.py), so the table's gradient is (ids, rows): O(touched
rows), not O(vocab).  The optimizer ops with a sparse branch (sgd,
momentum, adam; ops/optim.py) update the merged rows only; every other
op receives the densified gradient (`densify`).

Duplicate ids are merged the reference's way (MergeAdd): a stable sort
of the ids, then one sum per run of equal ids in the sorted order
(`torch.segment_reduce`, each output summed by one thread in order), so
the sums have the same bits on every run; no atomic adds.
"""

from __future__ import annotations

import torch


class SparseGrad:
    """Gradient of an embedding table as touched rows.

    ids:  (N,) integer row indices into the table; they may repeat
          (scatter-add semantics make that the summed gradient).
    rows: (N, D) float gradient rows, one per lookup position.
    dense_shape: (vocab, D) of the full table.
    """

    def __init__(self, ids, rows, dense_shape):
        self.ids = ids
        self.rows = rows
        self.dense_shape = tuple(dense_shape)

    def merged(self):
        """(valid, ids, rows) with duplicate ids summed, as the
        reference lays it out: the sorted unique ids first, their summed
        rows beside them, `valid` marking those entries; the N - U slots
        after them hold id 0 and zero rows.  Syncs with the device once
        (the number of unique ids)."""
        ids, rows = self.unique_rows()
        n, u = self.ids.shape[0], ids.shape[0]
        valid = torch.arange(n, device=ids.device) < u
        pad_ids = torch.zeros(n - u, dtype=ids.dtype, device=ids.device)
        pad_rows = rows.new_zeros((n - u,) + tuple(rows.shape[1:]))
        return (valid, torch.cat([ids, pad_ids]),
                torch.cat([rows, pad_rows]))

    def unique_rows(self):
        """(ids, rows): the sorted unique ids and, for each, the sum of
        its rows in their original order — the valid part of
        `merged()`, which the optimizers update.  An id outside the
        table after one wrap of negatives is dropped, as the
        reference's scatter drops it."""
        from ..ops.common import fill_index

        ids, bad = fill_index(self.ids.reshape(-1), self.dense_shape[0])
        rows = self.rows
        if bool(bad.any()):
            ids, rows = ids[~bad], rows[~bad]
        order = torch.sort(ids, stable=True).indices
        uniq, counts = torch.unique_consecutive(ids[order],
                                                return_counts=True)
        rows = torch.segment_reduce(rows[order], "sum",
                                    lengths=counts, axis=0)
        return uniq, rows

    def to_dense(self):
        """The dense gradient (what the dense backward gives): the merged
        rows written into a zero table."""
        ids, rows = self.unique_rows()
        table = rows.new_zeros(self.dense_shape)
        table[ids] = rows
        return table

    def __repr__(self):
        return (f"SparseGrad(ids={tuple(self.ids.shape)}, "
                f"rows={tuple(self.rows.shape)}, "
                f"dense_shape={self.dense_shape})")


def densify(value):
    """Pass tensors through; densify SparseGrads (for ops without a
    sparse branch — the reference's get_tensor_from_selected_rows)."""
    if isinstance(value, SparseGrad):
        return value.to_dense()
    return value
