"""RecordIO in the port (paddle_tpu_torch/data/recordio.py and the native
codec paddle_tpu_torch/native/recordio.cc) against the reference's:
round trips, CRC corruption, both compressors, the native build, and
shards crossing between the packages in both directions with the two
codecs byte-identical.  Exact: bytes and arrays are compared equal."""

import os

import numpy as np
import pytest

from paddle_tpu.data import recordio as ref_rio
from paddle_tpu_torch import native
from paddle_tpu_torch.data import recordio as port_rio

COMPRESSORS = [port_rio.COMPRESS_NONE, port_rio.COMPRESS_ZLIB]


def _records(n=23, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.bytes(int(rng.randint(0, 300))) for _ in range(n)]


def _write(mod, path, records, compressor, chunk=5):
    with mod.Writer(path, max_chunk_records=chunk,
                    compressor=compressor) as w:
        for r in records:
            w.write(r)


def test_native_codec_builds_into_the_build_folder():
    lib = native.recordio_lib()
    assert lib is not None, native.build_error
    assert port_rio.codec() == "native"
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "paddle_tpu_torch"
    assert not any(p.suffix == ".so"
                   for p in native.SRC.parent.iterdir())


@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_round_trip_both_codecs(tmp_path, monkeypatch, compressor):
    recs = _records()
    p_native = str(tmp_path / "native.rio")
    _write(port_rio, p_native, recs, compressor)
    assert list(port_rio.Scanner(p_native)) == recs
    # the pure-Python codec (the fallback without a toolchain) writes the
    # same bytes and reads them back
    monkeypatch.setattr(native, "recordio_lib", lambda: None)
    assert port_rio.codec() == "python"
    p_py = str(tmp_path / "python.rio")
    _write(port_rio, p_py, recs, compressor)
    assert open(p_py, "rb").read() == open(p_native, "rb").read()
    assert list(port_rio.Scanner(p_native)) == recs


@pytest.mark.parametrize("compressor", COMPRESSORS)
@pytest.mark.parametrize("codec", ["native", "python"])
def test_crc_corruption_raises(tmp_path, monkeypatch, compressor, codec):
    """As tests/test_weak_items.py:238 for the reference."""
    p = str(tmp_path / "c.rio")
    _write(port_rio, p, _records(8), compressor, chunk=8)
    raw = bytearray(open(p, "rb").read())
    raw[-3] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    if codec == "python":
        monkeypatch.setattr(native, "recordio_lib", lambda: None)
    with pytest.raises(IOError, match="CRC"):
        list(port_rio.Scanner(p))


@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_shards_cross_between_packages(tmp_path, compressor):
    recs = _records(31, seed=3)
    p_ref = str(tmp_path / "ref.rio")
    p_port = str(tmp_path / "port.rio")
    _write(ref_rio, p_ref, recs, compressor, chunk=7)
    _write(port_rio, p_port, recs, compressor, chunk=7)
    assert open(p_ref, "rb").read() == open(p_port, "rb").read()
    assert list(port_rio.Scanner(p_ref)) == recs
    assert list(ref_rio.Scanner(p_port)) == recs


def test_array_records_cross_between_packages(tmp_path):
    rng = np.random.RandomState(4)
    samples = [(rng.rand(3, 4).astype(np.float32),
                rng.randint(0, 9, (5,)).astype(np.int64),
                np.asarray(i, np.int32)) for i in range(6)]
    p_ref, p_port = str(tmp_path / "a.rio"), str(tmp_path / "b.rio")
    assert ref_rio.write_arrays(p_ref, samples, max_chunk_records=4) == 6
    assert port_rio.write_arrays(p_port, samples, max_chunk_records=4) == 6
    assert open(p_ref, "rb").read() == open(p_port, "rb").read()
    for got in (list(port_rio.reader_creator(p_ref)()),
                list(ref_rio.read_arrays(p_port))):
        for want, have in zip(samples, got):
            for a, b in zip(want, have):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_truncated_and_bad_magic_raise(tmp_path):
    p = str(tmp_path / "t.rio")
    _write(port_rio, p, _records(4), port_rio.COMPRESS_ZLIB)
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[:-5])
    with pytest.raises(IOError, match="truncated"):
        list(port_rio.Scanner(p))
    open(p, "wb").write(b"\0" * len(raw))
    with pytest.raises(IOError, match="magic"):
        list(port_rio.Scanner(p))
    assert os.path.getsize(p) == len(raw)


def test_train_demo_builds_and_trains(tmp_path):
    """The C++ entry point (paddle_tpu_torch/native/train_demo.cc, built
    by build_demo.sh into _build/) trains the port from an embedded
    interpreter, here on the CPU."""
    import subprocess
    import sys

    script = native.SRC.parent / "build_demo.sh"
    env = dict(os.environ, PYTHON=sys.executable)
    subprocess.run(["sh", str(script)], check=True, capture_output=True,
                   env=env, timeout=120)
    demo = native.BUILD_DIR / "train_demo"
    proc = subprocess.run([str(demo), "4"], capture_output=True, text=True,
                          env=dict(env, PADDLE_DEMO_PLACE="cpu"),
                          cwd=str(tmp_path), timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.count("loss=") == 4
    assert "train_demo ok" in proc.stdout
