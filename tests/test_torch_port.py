"""Package contracts of the PyTorch port (paddle_tpu_torch).

- It imports neither jax nor paddle_tpu nor ml_dtypes: a subprocess
  imports every one of its modules with the three blocked in
  sys.modules.
- Places: without an explicit place the entry points mean CUDAPlace(0)
  and raise when CUDA is absent, instead of running on the CPU.
- The CUDA sources of the ported kernels are in the package, each with
  the C entry point its wrapper binds; a library's name hashes its
  source and the csrc headers the source includes.
- Not-ported options raise NotImplementedError naming the ROADMAP item.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.executor import Executor, place_device
from paddle_tpu_torch.models.decoder_lm import DecoderLM
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.serving.decode import DecodeConfig, DecodeEngine

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "paddle_tpu_torch"

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now fails
sys.modules["paddle_tpu"] = None   # and so does the reference package
sys.modules["ml_dtypes"] = None    # the card's machine lacks it
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    paddle_tpu_torch.__path__, "paddle_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m in ("jax", "paddle_tpu", "ml_dtypes")
                  or m.startswith(("jax.", "paddle_tpu.", "ml_dtypes."))))
assert not bad, bad
print(len(names))
"""


def test_imports_with_jax_and_paddle_tpu_blocked():
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout.strip()) >= 20      # every module was imported


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "chip_ab.py"]))
def test_source_names_no_jax_import(path):
    src = (REPO / path).read_text()
    assert not re.search(r"^\s*(import jax|from jax)", src, re.M), path
    assert not re.search(r"^\s*(import|from) paddle_tpu(\.|\s|$)", src,
                         re.M), path
    assert not re.search(r"^\s*(import|from) ml_dtypes", src, re.M), path


def test_default_place_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Executor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        place_device(pt.CUDAPlace(0))
    lm = DecoderLM(vocab_size=16, n_layer=1, n_head=2, d_model=8,
                   d_inner=16, kv_dtype="float32")
    cfg = DecodeConfig(num_slots=1, page_size=4, max_len=8,
                       prefill_buckets=(4,), kv_dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeEngine(lm, cfg)
    assert place_device(pt.CPUPlace()) == torch.device("cpu")


@pytest.mark.parametrize("name,entry", [
    ("paged_attention", "paged_attention_launch"),
    ("flash_attention_fwd", "flash_attention_fwd_launch"),
    ("flash_attention_bwd", "flash_attention_bwd_dkv_launch"),
    ("flash_attention_bwd", "flash_attention_bwd_dq_launch"),
    ("vocab_ce", "vocab_ce_fwd_launch"),
    ("lstm", "lstm_fwd_launch"),
    ("lstm", "lstm_bwd_launch"),
    ("lstm", "l2_read_probe_launch"),
])
def test_kernel_sources_exist(name, entry):
    src = PKG / "csrc" / f"{name}.cu"
    assert name in _build.KERNEL_SOURCES
    text = src.read_text()
    assert f'extern "C" int {entry}(' in text
    assert "paddle_tpu/ops/pallas/" in text     # names the TPU kernel
    assert _build.library_path(name).parent == _build.BUILD_DIR


def test_chip_ab_takes_the_phases_to_run(monkeypatch, capsys):
    """chip_ab.py: the phases after the two trees must be chip_smoke
    phases it knows (else usage, exit 2), none means its default, and
    without CUDA it stops before running anything (exit 1)."""
    sys.path.insert(0, str(REPO))
    import chip_ab

    assert chip_ab.DEFAULT == ("fwd", "6d", "6")
    assert set(chip_ab.DEFAULT) <= set(chip_ab.PHASES)
    assert {"6c", "6e", "stream", "bwd16", "6i", "6j"} <= \
        set(chip_ab.PHASES)
    assert chip_ab.main(["a", "b", "6x"]) == 2
    assert chip_ab.main(["a"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_ab.main(["a", "b", "6c", "6e"]) == 1
    assert chip_ab.main(["a", "b"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_library_path_hashes_the_included_headers(tmp_path, monkeypatch):
    """Editing csrc/flash_mma.cuh renames the library of both flash
    sources and of the LSTM source, which include it, and of no other
    source: an edited header rebuilds, an unchanged source still loads
    from disk."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in (PKG / "csrc").iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    assert [p.name for p in _build.source_files("flash_attention_fwd")] == \
        ["flash_attention_fwd.cu", "flash_mma.cuh"]
    before = {n: _build.library_path(n) for n in _build.KERNEL_SOURCES}
    with open(csrc / "flash_mma.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build.library_path(n) for n in _build.KERNEL_SOURCES}
    changed = {n for n in _build.KERNEL_SOURCES if before[n] != after[n]}
    assert changed == {"flash_attention_fwd", "flash_attention_bwd", "lstm"}


@pytest.mark.parametrize("kw,item", [
    (dict(role="prefill"), "queue A item 7"),
    (dict(role="decode"), "queue A item 7"),
])
def test_unported_engine_options_raise(kw, item):
    lm = DecoderLM(vocab_size=16, n_layer=1, n_head=2, d_model=8,
                   d_inner=16, kv_dtype="float32")
    with pytest.raises(NotImplementedError, match=item):
        DecodeEngine(lm, DecodeConfig(num_slots=1, page_size=4, max_len=8,
                                      prefill_buckets=(4,),
                                      kv_dtype="float32"),
                     place=pt.CPUPlace(), **kw)


def test_cpu_engine_start_warms_up_and_reports():
    lm = DecoderLM(vocab_size=16, n_layer=1, n_head=2, d_model=8,
                   d_inner=16, kv_dtype="float32")
    cfg = DecodeConfig(num_slots=2, page_size=4, max_len=16,
                       prefill_buckets=(4, 8), kv_dtype="float32")
    eng = DecodeEngine(lm, cfg, place=pt.CPUPlace()).start()
    try:
        assert eng.fit_plan == {"skipped": "plan_fit not ported",
                                "budget_bytes": None}
        assert eng.stats.snapshot()["warmup"]["executables"] == 3
        # warmup wrote nothing into the pools
        assert all(float(p.abs().sum()) == 0 for p in eng._pools.values())
        with pytest.raises(NotImplementedError, match="queue A item 7"):
            eng.reload({})
    finally:
        eng.close()


def test_engine_event_log(tmp_path):
    """log_path: the engine writes its start, warmup and drain records
    as JSONL, one object per line."""
    import json

    lm = DecoderLM(vocab_size=16, n_layer=1, n_head=2, d_model=8,
                   d_inner=16, kv_dtype="float32")
    cfg = DecodeConfig(num_slots=2, page_size=4, max_len=16,
                       prefill_buckets=(4,), kv_dtype="float32")
    path = tmp_path / "events.jsonl"
    eng = DecodeEngine(lm, cfg, place=pt.CPUPlace(), log_path=str(path))
    eng.start()
    assert len(eng.generate([1, 2, 3], max_new_tokens=3,
                            timeout_s=60)) == 3
    eng.close()
    kinds = [json.loads(ln)["event"] for ln in
             path.read_text().splitlines()]
    assert kinds[0] == "run_begin" and kinds[-1] == "run_end"
    for k in ("serving_decode_start", "serving_decode_warmup",
              "serving_decode_drain"):
        assert k in kinds, kinds


def test_page_pool_allocator():
    from paddle_tpu_torch.serving.decode import PagePool

    pool = PagePool(6)
    a = pool.alloc(2)
    b = pool.alloc(3)
    assert len(a) == 2 and len(b) == 3 and pool.free_pages == 1
    assert pool.alloc(2) is None and pool.free_pages == 1
    pool.free(a)
    c = pool.alloc(3)
    assert c is not None and pool.in_use == 6
    assert len(set(b) | set(c)) == 6  # disjoint, covering the pool


@pytest.mark.parametrize("kw", [
    dict(num_pages=2, page_size=4, max_len=64),   # pool below one slot
    dict(prefill_buckets=(64, 32)),               # not ascending
    dict(prefill_buckets=(512,), max_len=256),    # bucket past max_len
])
def test_config_validation(kw):
    with pytest.raises(ValueError):
        DecodeConfig(**kw)


def test_submit_rejections():
    from paddle_tpu_torch.serving.decode import DecodeBucketMissError

    lm = DecoderLM(vocab_size=16, n_layer=1, n_head=2, d_model=8,
                   d_inner=16, kv_dtype="float32")
    cfg = DecodeConfig(num_slots=2, page_size=4, max_len=24,
                       num_pages=12, prefill_buckets=(8,),
                       decode_chunk=2, kv_dtype="float32")
    eng = DecodeEngine(lm, cfg, place=pt.CPUPlace()).start()
    try:
        with pytest.raises(DecodeBucketMissError):
            eng.submit(np.ones(9, np.int64))    # over the bucket ladder
        with pytest.raises(DecodeBucketMissError):
            eng.submit(np.ones(8, np.int64), max_new_tokens=17)
        assert eng.stats.snapshot()["bucket_misses"] == 2
    finally:
        eng.close()
