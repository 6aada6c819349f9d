"""Data plane: readers, decorators, datasets, DataFeeder, RecordIO, the
MultiSlot feed, the shard lease queue and the device-fed pipeline — the
port of paddle_tpu/data.

reference: python/paddle/reader/decorator.py (shuffle/chain/compose/
buffered/firstn/map_readers/xmap_readers:58-338), python/paddle/dataset/
(auto-downloading datasets), python/paddle/fluid/data_feeder.py.
"""

from . import pipeline  # noqa: F401
from .data_feeder import DataFeeder  # noqa: F401
from .decorator import (Fake, batch, buffered, chain, compose,  # noqa: F401
                        firstn, map_readers, multiprocess_reader, shuffle,
                        xmap_readers)
from . import dataset  # noqa: F401
from . import image  # noqa: F401
