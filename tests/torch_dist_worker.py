"""One rank of a `torch_dist_harness.RankGroup`.

`python tests/torch_dist_worker.py RANK N PORT GENERATION BOOTSTRAP`:
joins the harness's TCPStore at 127.0.0.1:PORT, starts the gloo process
group — on that store ("store") or through
`paddle_tpu_torch.parallel.init_distributed` from the PADDLE_* env
variables ("env") — then runs the cases the harness posts, one after
another, each a function of `tests/torch_dp_cases.py` (or, named
"module:function", of another case module beside it) called on every
rank, until it is told to stop or the harness goes away.  Imports
torch, numpy and the port only.
"""

import os
import pickle
import sys
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist


def main():
    import faulthandler
    import signal

    # the harness asks for every thread's stack before it kills a group
    # that missed its timeout
    faulthandler.register(signal.SIGUSR1)
    rank, n, port, gen, bootstrap = sys.argv[1:6]
    rank, n, gen = int(rank), int(n), int(gen)
    torch.set_num_threads(1)
    ctl = dist.TCPStore("127.0.0.1", int(port), is_master=False,
                        timeout=timedelta(seconds=60))
    if bootstrap == "env":
        import paddle_tpu_torch as pt

        pt.parallel.init_distributed(place=pt.CPUPlace(), health=False,
                                     timeout_s=60)
    else:
        dist.init_process_group(
            "gloo", store=dist.PrefixStore(f"pg{gen}", ctl), rank=rank,
            world_size=n, timeout=timedelta(seconds=30))
    import torch_dp_cases as cases

    parent = os.getppid()
    ctl.set(f"g{gen}/ready/{rank}", "1")
    k = 0
    while True:
        key = f"g{gen}/case/{k}"
        try:
            ctl.wait([key], timedelta(seconds=2))
        except Exception:  # noqa: BLE001 — the store's timeout
            if os.getppid() != parent:
                return 0        # the harness went away
            continue
        req = pickle.loads(ctl.get(key))
        if req is None:
            break
        fn, kwargs = req
        try:
            mod = cases
            if ":" in fn:
                import importlib

                name, fn = fn.split(":")
                mod = importlib.import_module(name)
            res = ("ok", getattr(mod, fn)(rank=rank, world=n, **kwargs))
        except BaseException:  # noqa: BLE001 — reported to the harness
            res = ("err", traceback.format_exc())
        ctl.set(f"g{gen}/result/{k}/{rank}", pickle.dumps(res))
        k += 1
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
