"""DataFeed: file-shard parsing for the async CTR training path — the
port of paddle_tpu/data/data_feed.py, pure host code and unchanged.

The analog of the reference's DataFeed stack
(reference: paddle/fluid/framework/data_feed.h:49 — DataFeed virtual
reader; MultiSlotDataFeed text parser; data_feed.proto schema;
python/paddle/fluid/data_feed_desc.py DataFeedDesc wrapper).

The MultiSlot text format (one sample per line): for each slot in schema
order, an integer count N followed by N values (ints for sparse id
slots, floats for dense slots), whitespace-separated — the classic CTR
log line.  Batches come out as padded numpy dicts matching the
framework's padded+seq_len ragged representation.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


class DataFeedDesc:
    """Schema for MultiSlot parsing (reference data_feed_desc.py, backed
    by data_feed.proto; JSON here instead of protobuf text).

        desc = DataFeedDesc.from_slots([
            {"name": "ids", "type": "uint64", "dense": False,
             "max_len": 20},
            {"name": "dense_vals", "type": "float", "dense": True,
             "dim": 13},
            {"name": "label", "type": "uint64", "dense": True, "dim": 1},
        ], batch_size=32)
    """

    def __init__(self, proto_desc: Optional[str] = None):
        self.slots: List[dict] = []
        self.batch_size = 1
        if proto_desc:
            d = json.loads(proto_desc)
            self.slots = d["slots"]
            self.batch_size = d.get("batch_size", 1)

    @classmethod
    def from_slots(cls, slots: Sequence[dict], batch_size: int = 1):
        desc = cls()
        desc.slots = [dict(s) for s in slots]
        desc.batch_size = batch_size
        return desc

    def set_batch_size(self, batch_size: int):
        self.batch_size = int(batch_size)

    def set_use_slots(self, use_slots: Sequence[str]):
        use = set(use_slots)
        for s in self.slots:
            s["used"] = s["name"] in use

    def desc(self) -> str:
        return json.dumps({"slots": self.slots,
                           "batch_size": self.batch_size})


class MultiSlotDataFeed:
    """Parser over text file shards (reference MultiSlotDataFeed,
    data_feed.cc).  Yields padded batch dicts: sparse slots become
    (B, max_len) int64 + "<name>.seq_len"; dense slots (B, dim)."""

    def __init__(self, desc: DataFeedDesc):
        self.desc = desc

    def _parse_line(self, line: str):
        toks = line.split()
        pos = 0
        sample = {}
        for slot in self.desc.slots:
            n = int(toks[pos])
            pos += 1
            vals = toks[pos:pos + n]
            if len(vals) != n:
                raise ValueError(
                    f"corrupt MultiSlot line: slot {slot['name']!r} "
                    f"declares {n} values, found {len(vals)}")
            pos += n
            if slot.get("used", True) is False:
                continue
            if slot.get("type", "uint64").startswith("float"):
                sample[slot["name"]] = np.asarray(vals, np.float32)
            else:
                # CTR hash ids use the full uint64 range; parse as uint64
                # then reinterpret into the framework's int64 id dtype
                # (bit pattern preserved, distinctness preserved)
                sample[slot["name"]] = np.asarray(
                    [int(v) for v in vals], np.uint64).astype(np.int64)
        return sample

    def read_file(self, path: str) -> Iterable[dict]:
        # RecordIO shards (sniffed by chunk magic) carry one MultiSlot
        # line per record — the reference's recordio DataFeed variant
        # (data_feed.cc MultiSlotType over recordio chunks); plain files
        # are newline-separated text
        if self._is_recordio(path):
            from . import recordio

            for rec in recordio.Scanner(path):
                line = rec.decode("utf-8").strip()
                if line:
                    yield self._parse_line(line)
            return
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield self._parse_line(line)

    @staticmethod
    def _is_recordio(path: str) -> bool:
        from . import recordio

        with open(path, "rb") as f:
            head = f.read(4)
        return (len(head) == 4 and
                int.from_bytes(head, "little") == recordio.MAGIC)

    def batches(self, paths: Sequence[str]) -> Iterable[Dict[str, np.ndarray]]:
        buf: List[dict] = []
        bs = self.desc.batch_size
        for p in paths:
            for sample in self.read_file(p):
                buf.append(sample)
                if len(buf) == bs:
                    yield self._collate(buf)
                    buf = []
        # trailing partial batch dropped (static shapes; reference's
        # DataFeed also pads/drops at shard ends)

    def _collate(self, samples: List[dict]) -> Dict[str, np.ndarray]:
        batch: Dict[str, np.ndarray] = {}
        for slot in self.desc.slots:
            if slot.get("used", True) is False:
                continue
            name = slot["name"]
            vals = [s[name] for s in samples]
            if slot.get("dense", False):
                dim = int(slot.get("dim", len(vals[0])))
                arr = np.zeros((len(vals), dim), vals[0].dtype)
                for i, v in enumerate(vals):
                    arr[i, :len(v)] = v[:dim]
                batch[name] = arr
            else:
                if "max_len" not in slot:
                    raise ValueError(
                        f"sparse slot {name!r} needs a 'max_len': batch "
                        f"shapes must be static (padding to each batch's "
                        f"own max would break declared feed shapes)")
                max_len = int(slot["max_len"])
                arr = np.zeros((len(vals), max_len), np.int64)
                lens = np.zeros((len(vals),), np.int32)
                for i, v in enumerate(vals):
                    k = min(len(v), max_len)
                    arr[i, :k] = v[:k]
                    lens[i] = k
                batch[name] = arr
                batch[f"{name}.seq_len"] = lens
        return batch
