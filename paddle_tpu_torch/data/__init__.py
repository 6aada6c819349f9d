"""Data plane: reader decorators and feed admission (the port of
paddle_tpu/data's decorator.py and the admission half of pipeline.py).

reference: python/paddle/reader/decorator.py (shuffle/chain/compose/
buffered/firstn/map_readers/xmap_readers:58-338).  The datasets,
`DataFeeder`, `DeviceFeeder` and `PyReader` are not ported yet: ROADMAP
queue A step 12.
"""

from . import pipeline  # noqa: F401
from .decorator import (Fake, batch, buffered, chain, compose,  # noqa: F401
                        firstn, map_readers, multiprocess_reader, shuffle,
                        xmap_readers)
