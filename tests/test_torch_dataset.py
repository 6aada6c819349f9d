"""The port's datasets (paddle_tpu_torch/data/dataset.py), DataFeeder,
image transforms and batching helpers against the reference's: the 14
synthetic readers (13 dataset classes, cifar's 10 and 100 apart) and
the real-format parsers (over files the tests write, as
tests/test_io_data.py:233-923 does) give equal samples; host code, held
exactly (every array equal, dtype included)."""

import io as _io
import os
import pickle
import tarfile

import numpy as np
import pytest

import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu.data import dataset as ref_ds
from paddle_tpu.data import image as ref_image
from paddle_tpu_torch.data import dataset as port_ds
from paddle_tpu_torch.data import image as port_image

from tests.test_io_data import (_write_conll05_fixture,
                                _write_flowers_fixture,
                                _write_imikolov_fixture,
                                _write_mnist_fixture,
                                _write_movielens_fixture,
                                _write_mq2007_fixture,
                                _write_sentiment_fixture,
                                _write_voc2012_fixture,
                                _write_wmt14_fixture, _write_wmt16_fixture)

FIRST = 4    # samples compared per synthetic reader


@pytest.fixture(autouse=True)
def _no_dataset_home(monkeypatch):
    monkeypatch.delenv("PADDLE_DATASET_HOME", raising=False)


def _same(a, b, where="sample"):
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    else:
        assert a == b, (where, a, b)


def _take(reader, n=None):
    out = []
    for s in reader():
        out.append(s)
        if n is not None and len(out) == n:
            break
    return out


SYNTHETIC = {
    "mnist": lambda ds: ds.mnist.train(n=6),
    "cifar": lambda ds: ds.cifar.train10(n=6),
    "flowers": lambda ds: ds.flowers.train(n=6),
    "uci_housing": lambda ds: ds.uci_housing.test(n=6),
    "imdb": lambda ds: ds.imdb.train(n=6, max_len=128),
    "imikolov": lambda ds: ds.imikolov.train(n=5),
    "movielens": lambda ds: ds.movielens.train(n=6),
    "wmt14": lambda ds: ds.wmt14.train(30, n=6),
    "wmt16": lambda ds: ds.wmt16.train(30, 40, n=6),
    "conll05": lambda ds: ds.conll05.test(n=6),
    "mq2007": lambda ds: ds.mq2007.train("listwise", n_queries=3),
    "sentiment": lambda ds: ds.sentiment.train(n=6),
    "voc2012": lambda ds: ds.voc2012.train(n=3),
    "cifar100": lambda ds: ds.cifar.train100(n=6),
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_readers_equal_the_reference(name):
    want = _take(SYNTHETIC[name](ref_ds), FIRST)
    got = _take(SYNTHETIC[name](port_ds), FIRST)
    assert want
    _same(got, want, name)


# -- real-format fixtures the reference's tests do not write as helpers --

def _write_cifar(d):
    rng = np.random.RandomState(4)
    data = rng.randint(0, 256, (8, 3072)).astype(np.uint8)
    labels = rng.randint(0, 10, (8,)).tolist()
    with tarfile.open(os.path.join(d, "cifar-10-python.tar.gz"),
                      "w:gz") as t:
        for name, sl in (("cifar-10-batches-py/data_batch_1", slice(0, 5)),
                         ("cifar-10-batches-py/test_batch", slice(5, 8))):
            payload = pickle.dumps({b"data": data[sl],
                                    b"labels": labels[sl]})
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            t.addfile(info, _io.BytesIO(payload))


def _write_uci(d):
    table = np.random.RandomState(5).rand(10, 14) * 10
    with open(os.path.join(d, "housing.data"), "w") as f:
        for row in table:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")


def _write_imdb(d):
    docs = {"aclImdb/train/pos/0_9.txt": b"a great great movie!",
            "aclImdb/train/neg/0_2.txt": b"a terrible movie.",
            "aclImdb/test/pos/0_8.txt": b"great fun"}
    with tarfile.open(os.path.join(d, "aclImdb_v1.tar.gz"), "w:gz") as t:
        for name, text in docs.items():
            info = tarfile.TarInfo(name)
            info.size = len(text)
            t.addfile(info, _io.BytesIO(text))


def _imdb(ds, d):
    wd = ds.imdb.build_dict(os.path.join(d, "aclImdb_v1.tar.gz"), cutoff=0)
    return [wd, _take(ds.imdb.train(wd, data_dir=d)),
            _take(ds.imdb.test(wd, data_dir=d))]


def _imikolov(ds, d):
    wd = ds.imikolov.build_dict(min_word_freq=1, data_dir=d)
    return [wd, _take(ds.imikolov.train(wd, n=3, data_dir=d)),
            _take(ds.imikolov.test(wd, n=2, data_dir=d))]


def _sentiment(ds, d):
    return [ds.sentiment.get_word_dict(data_dir=d),
            _take(ds.sentiment.reader_creator(d, is_test=False)),
            _take(ds.sentiment.reader_creator(d, is_test=True))]


REAL = {
    "mnist": (_write_mnist_fixture,
              lambda ds, d: _take(ds.mnist.train(data_dir=d))),
    "cifar": (_write_cifar, lambda ds, d: [
        _take(ds.cifar.train10(data_dir=d)),
        _take(ds.cifar.test10(data_dir=d))]),
    "uci_housing": (_write_uci, lambda ds, d: [
        _take(ds.uci_housing.train(data_dir=d)),
        _take(ds.uci_housing.test(data_dir=d))]),
    "imdb": (_write_imdb, _imdb),
    "imikolov": (_write_imikolov_fixture, _imikolov),
    "movielens": (_write_movielens_fixture, lambda ds, d: [
        _take(ds.movielens.train(data_dir=d)),
        _take(ds.movielens.test(data_dir=d))]),
    "wmt14": (_write_wmt14_fixture, lambda ds, d: [
        _take(ds.wmt14.train(dict_size=7, data_dir=d)),
        _take(ds.wmt14.test(dict_size=7, data_dir=d)),
        ds.wmt14.get_dict(7, reverse=True, data_dir=d)]),
    "wmt16": (_write_wmt16_fixture, lambda ds, d: [
        _take(ds.wmt16.train(20, 20, data_dir=d)),
        _take(ds.wmt16.train(20, 20, src_lang="de", data_dir=d))]),
    "conll05": (_write_conll05_fixture, lambda ds, d: [
        ds.conll05.get_dict(d), _take(ds.conll05.test(data_dir=d))]),
    "mq2007": (_write_mq2007_fixture, lambda ds, d: [
        _take(ds.mq2007.train(fmt, data_dir=d))
        for fmt in ("pointwise", "pairwise", "listwise")]),
    "sentiment": (_write_sentiment_fixture, _sentiment),
    "voc2012": (_write_voc2012_fixture, lambda ds, d: [
        _take(ds.voc2012.train(data_dir=d)),
        _take(ds.voc2012.test(data_dir=d))]),
    "flowers": (_write_flowers_fixture, lambda ds, d: [
        _take(ds.flowers.train(data_dir=d)),
        _take(ds.flowers.test(data_dir=d))]),
}


@pytest.mark.parametrize("name", sorted(REAL))
def test_real_format_parsers_equal_the_reference(tmp_path, name):
    write, read = REAL[name]
    d = str(tmp_path)
    write(d)
    want = read(ref_ds, d)
    got = read(port_ds, d)
    assert want
    _same(got, want, name)


def test_mnist_corrupt_magic_fails_loudly(tmp_path):
    import gzip
    import struct

    d = str(tmp_path)
    _write_mnist_fixture(d)
    with gzip.open(os.path.join(d, "train-images-idx3-ubyte.gz"), "wb") as f:
        f.write(struct.pack(">IIII", 1234, 1, 28, 28))
    with pytest.raises(IOError, match="magic"):
        list(port_ds.mnist.train(data_dir=d)())


def _feeders(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ls = fluid.layers
        words = ls.data(name="w", shape=[-1], dtype="int64", lod_level=1,
                        append_batch_size=False)
        nested = ls.data(name="n", shape=[-1, -1, -1], dtype="float32",
                         lod_level=2, append_batch_size=False)
        label = ls.data(name="l", shape=[1], dtype="int64")
        return fluid.DataFeeder(feed_list=[words, nested, label],
                                program=main)


def test_data_feeder_pads_as_the_reference():
    rows = [([1, 2, 3], [[1.0, 2.0], [3.0]], 0),
            ([4, 5], [[5.0]], 1),
            ([6], [[6.0, 7.0, 8.0], [], [9.0]], 0)]
    want = _feeders(jf).feed(rows)
    got = _feeders(pt).feed(rows)
    _same(got, want, "feed")
    assert got["w"].shape == (3, 8) and got["w.seq_len"].tolist() == [3, 2, 1]
    assert got["n.seq_len2"].shape == (3, 8)
    assert isinstance(pt.data.DataFeeder, type)


def test_image_transforms_equal_the_reference():
    rng = np.random.RandomState(0)
    im = rng.randint(0, 256, (37, 50, 3)).astype(np.uint8)
    gray = rng.rand(20, 31).astype(np.float32)
    for fn, args in (("resize_short", (im, 24)), ("resize_short", (gray, 9)),
                     ("to_chw", (im,)), ("center_crop", (im, 20)),
                     ("left_right_flip", (im,))):
        _same(getattr(port_image, fn)(*args), getattr(ref_image, fn)(*args),
              fn)
    for train in (True, False):
        got = port_image.simple_transform(
            im, 32, 24, train, mean=[1.0, 2.0, 3.0],
            rng=np.random.RandomState(3))
        want = ref_image.simple_transform(
            im, 32, 24, train, mean=[1.0, 2.0, 3.0],
            rng=np.random.RandomState(3))
        _same(got, want, f"simple_transform(train={train})")
    with pytest.raises(ValueError, match="grayscale"):
        port_image.simple_transform(gray, 16, 8, False, mean=[1.0, 2.0])


HELPERS = {
    "padded_nmt_batches": lambda ds: ds.padded_nmt_batches(
        ds.wmt14.train(30, n=20), 4, 12, 12),
    "padded_text_batches": lambda ds: ds.padded_text_batches(
        ds.imdb.train(n=20, max_len=64), 4, 32),
    "ngram_batches": lambda ds: ds.ngram_batches(
        ds.imikolov.train(n=5), 4, 4),
    "srl_batches": lambda ds: ds.srl_batches(ds.conll05.test(n=20), 3, 40),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_batching_helpers_equal_the_reference(name):
    want = _take(HELPERS[name](ref_ds), 3)
    got = _take(HELPERS[name](port_ds), 3)
    assert want
    _same(got, want, name)
