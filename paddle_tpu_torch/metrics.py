"""Python-side metric accumulators: the port of paddle_tpu/metrics.py.

The analog of the reference's metrics module
(reference: python/paddle/fluid/metrics.py:1 — MetricBase, CompositeMetric,
Precision, Recall, Accuracy, ChunkEvaluator, EditDistance, DetectionMAP,
Auc).  These compose *across batches* on the host: per-batch statistics
come out of fetched ops (accuracy/auc/precision_recall ops or raw
predictions) and accumulate in numpy; nothing here runs on device.  An
update takes numpy arrays, Python numbers or torch tensors (fetched with
`return_numpy=False`, on any device): a tensor is read to the host once.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import numpy as np


def _to_np(x):
    """numpy view of a metric input; a torch tensor is detached and read
    to the host (bf16 widened to float32, exactly)."""
    import torch

    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class MetricBase:
    """reference metrics.py MetricBase: name + reset/update/eval."""

    def __init__(self, name: Optional[str] = None):
        self._name = name or self.__class__.__name__

    def reset(self):
        """Zero every accumulator attribute (reference resets all
        non-underscore state)."""
        states = {k: v for k, v in self.__dict__.items()
                  if not k.startswith("_")}
        for k, v in states.items():
            if isinstance(v, int):
                setattr(self, k, 0)
            elif isinstance(v, float):
                setattr(self, k, 0.0)
            elif isinstance(v, (np.ndarray,)):
                setattr(self, k, np.zeros_like(v))
            elif isinstance(v, (list,)):
                setattr(self, k, [])

    def get_config(self):
        return {k: copy.deepcopy(v) for k, v in self.__dict__.items()
                if not k.startswith("_")}

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError

    @property
    def name(self):
        return self._name


class CompositeMetric(MetricBase):
    """Bundle several metrics updated with the same inputs
    (reference metrics.py CompositeMetric)."""

    def __init__(self, name=None):
        super().__init__(name)
        self._metrics: List[MetricBase] = []

    def add_metric(self, metric: MetricBase):
        if not isinstance(metric, MetricBase):
            raise TypeError("add_metric expects a MetricBase")
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds=preds, labels=labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    """Binary precision over thresholded predictions
    (reference metrics.py Precision)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = _to_np(preds)
        labels = _to_np(labels)
        rounded = (preds.reshape(-1) >= 0.5).astype(np.int64)
        flat = labels.reshape(-1)
        self.tp += int(np.sum((rounded == 1) & (flat == 1)))
        self.fp += int(np.sum((rounded == 1) & (flat == 0)))

    def eval(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap else 0.0


class Recall(MetricBase):
    """reference metrics.py Recall."""

    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = _to_np(preds)
        labels = _to_np(labels)
        rounded = (preds.reshape(-1) >= 0.5).astype(np.int64)
        flat = labels.reshape(-1)
        self.tp += int(np.sum((rounded == 1) & (flat == 1)))
        self.fn += int(np.sum((rounded == 0) & (flat == 1)))

    def eval(self):
        rel = self.tp + self.fn
        return float(self.tp) / rel if rel else 0.0


class Accuracy(MetricBase):
    """Weighted running mean of per-batch accuracies (reference
    metrics.py Accuracy — pairs with the accuracy op's batch value)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        if weight < 0:
            raise ValueError("weight must be non-negative")
        self.value += float(_to_np(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no batches accumulated")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    """Chunk-level precision/recall/F1 accumulation (reference
    metrics.py ChunkEvaluator; batch counts typically from a chunk_eval
    computation or host-side chunk extraction)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self.num_infer_chunks += int(_to_np(num_infer_chunks).reshape(-1)[0])
        self.num_label_chunks += int(_to_np(num_label_chunks).reshape(-1)[0])
        self.num_correct_chunks += int(
            _to_np(num_correct_chunks).reshape(-1)[0])

    def eval(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class EditDistance(MetricBase):
    """Average edit distance + instance error rate (reference
    metrics.py EditDistance; pairs with the edit_distance op's (Out,
    SequenceNum) fetches)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = _to_np(distances).reshape(-1)
        self.total_distance += float(np.sum(distances))
        self.seq_num += int(_to_np(seq_num).reshape(-1)[0])
        self.instance_error += int(np.sum(distances != 0))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no batches accumulated")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class Auc(MetricBase):
    """Threshold-bucketed ROC AUC accumulator (reference metrics.py Auc:
    _stat_pos/_stat_neg histograms + trapezoid integration), composable
    across batches."""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        if curve != "ROC":
            raise ValueError("only ROC supported")
        self._num_thresholds = num_thresholds
        self.stat_pos = np.zeros(num_thresholds + 1, np.int64)
        self.stat_neg = np.zeros(num_thresholds + 1, np.int64)

    def update(self, preds, labels):
        """preds: (N, 2) class probabilities (or (N,) positive scores);
        labels: (N,) / (N,1) binary."""
        preds = _to_np(preds)
        labels = _to_np(labels).reshape(-1).astype(np.int64)
        pos_score = preds[:, -1] if preds.ndim == 2 else preds.reshape(-1)
        idx = np.clip((pos_score * self._num_thresholds).astype(np.int64),
                      0, self._num_thresholds)
        np.add.at(self.stat_pos, idx[labels == 1], 1)
        np.add.at(self.stat_neg, idx[labels == 0], 1)

    def eval(self):
        # sweep thresholds from high to low, trapezoid over (fp, tp)
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self._num_thresholds, -1, -1):
            prev_pos, prev_neg = tot_pos, tot_neg
            tot_pos += float(self.stat_pos[i])
            tot_neg += float(self.stat_neg[i])
            auc += (tot_neg - prev_neg) * (tot_pos + prev_pos) / 2.0
        denom = tot_pos * tot_neg
        return auc / denom if denom else 0.0


class DetectionMAP(MetricBase):
    """Running mean of per-batch mAP values (reference metrics.py
    DetectionMAP — accumulates the detection_map computation's output)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1.0):
        self.value += float(_to_np(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no batches accumulated")
        return self.value / self.weight
