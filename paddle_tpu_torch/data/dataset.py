"""Built-in datasets: the port of paddle_tpu/data/dataset.py, host
parsing and synthetic generators unchanged (each reader gives the
reference package's samples; `scipy` and `PIL` are imported only by the
parsers that need them).

reference: python/paddle/dataset/ — mnist, cifar, uci_housing, imdb,
imikolov, movielens, wmt14/16 auto-download readers.  This environment
is zero-egress, so downloading is impossible; instead each dataset has
BOTH:

- a real-format file parser (`reader_creator` / `data_dir=` arg) that
  ingests the dataset's actual on-disk format — MNIST idx-ubyte .gz
  (dataset/mnist.py:43 reader_creator), CIFAR python-pickle tar
  (dataset/cifar.py reader_creator), UCI housing whitespace table with
  the reference's avg/min-max normalization (uci_housing.py:68
  load_data) — used whenever files are present (point `data_dir` or
  $PADDLE_DATASET_HOME at them), and
- a deterministic synthetic generator with the real shapes/dtypes/label
  spaces as the zero-egress fallback.

The reader contract is the reference's: zero-arg callable yielding
samples.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np


def _dataset_home(sub):
    home = os.environ.get("PADDLE_DATASET_HOME")
    return os.path.join(home, sub) if home else None


def _find_archive(data_dir, sub, names):
    """Probe `data_dir` (or $PADDLE_DATASET_HOME/sub) for the first
    existing archive filename in `names`; None when absent."""
    if data_dir is None:
        data_dir = _dataset_home(sub)
    if data_dir is None:
        return None
    for name in names:
        p = os.path.join(data_dir, name)
        if os.path.exists(p):
            return p
    return None


def _synthetic_classification(n, feature_shape, num_classes, seed,
                              flatten=False):
    rng = np.random.RandomState(seed)
    centers = rng.randn(num_classes, *feature_shape).astype(np.float32)

    def reader():
        r = np.random.RandomState(seed + 1)
        for _ in range(n):
            y = int(r.randint(num_classes))
            x = centers[y] + 0.5 * r.randn(*feature_shape).astype(np.float32)
            if flatten:
                x = x.reshape(-1)
            yield x, y

    return reader


class mnist:
    """28x28 grayscale digits, labels 0-9 (dataset/mnist.py)."""

    TRAIN_IMAGES = "train-images-idx3-ubyte.gz"
    TRAIN_LABELS = "train-labels-idx1-ubyte.gz"
    TEST_IMAGES = "t10k-images-idx3-ubyte.gz"
    TEST_LABELS = "t10k-labels-idx1-ubyte.gz"

    @staticmethod
    def reader_creator(image_filename, label_filename):
        """Parse the REAL idx-ubyte format (dataset/mnist.py:43): gzip'd
        big-endian headers (magic 2051 images / 2049 labels), raw u8
        pixels scaled to [-1, 1) exactly like the reference
        (`images / 255.0 * 2.0 - 1.0`); yields (flat f32 784, int)."""

        def reader():
            with gzip.open(image_filename, "rb") as f:
                magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                if magic != 2051:
                    raise IOError(
                        f"bad idx3 magic {magic} in {image_filename}")
                images = np.frombuffer(f.read(n * rows * cols),
                                       np.uint8).reshape(n, rows * cols)
            with gzip.open(label_filename, "rb") as f:
                magic, ln = struct.unpack(">II", f.read(8))
                if magic != 2049:
                    raise IOError(
                        f"bad idx1 magic {magic} in {label_filename}")
                labels = np.frombuffer(f.read(ln), np.uint8)
            if ln != n:
                raise IOError(f"mnist: {n} images but {ln} labels")
            imgs = images.astype(np.float32) / 255.0 * 2.0 - 1.0
            for i in range(n):
                yield imgs[i], int(labels[i])

        return reader

    @staticmethod
    def _files_in(data_dir, img, lbl):
        if data_dir is None:
            data_dir = _dataset_home("mnist")
        if data_dir is None:
            return None
        pi, pl = os.path.join(data_dir, img), os.path.join(data_dir, lbl)
        return (pi, pl) if (os.path.exists(pi)
                            and os.path.exists(pl)) else None

    @staticmethod
    def train(n=60000, seed=0, data_dir=None):
        real = mnist._files_in(data_dir, mnist.TRAIN_IMAGES,
                               mnist.TRAIN_LABELS)
        if real:
            return mnist.reader_creator(*real)
        return _synthetic_classification(n, (1, 28, 28), 10, seed)

    @staticmethod
    def test(n=10000, seed=7, data_dir=None):
        real = mnist._files_in(data_dir, mnist.TEST_IMAGES,
                               mnist.TEST_LABELS)
        if real:
            return mnist.reader_creator(*real)
        return _synthetic_classification(n, (1, 28, 28), 10, seed)


class cifar:
    @staticmethod
    def reader_creator(filename, sub_name):
        """Parse the REAL python-pickle tar format (dataset/cifar.py
        reader_creator): members whose name contains `sub_name` hold
        dicts with b'data' (N, 3072 u8) and b'labels'/b'fine_labels';
        pixels scale to [0, 1] f32 like the reference."""

        def reader():
            with tarfile.open(filename, mode="r") as f:
                names = [m.name for m in f if sub_name in m.name]
                for name in sorted(names):
                    batch = pickle.load(f.extractfile(name),
                                        encoding="bytes")
                    data = batch[b"data"]
                    labels = batch.get(b"labels",
                                       batch.get(b"fine_labels"))
                    if labels is None:
                        raise IOError(f"no labels in {name}")
                    for row, label in zip(data, labels):
                        yield ((np.asarray(row, np.uint8) / 255.0)
                               .astype(np.float32), int(label))

        return reader

    @staticmethod
    def _tar(data_dir, fname):
        return _find_archive(data_dir, "cifar", (fname,))

    @staticmethod
    def train10(n=50000, seed=1, data_dir=None):
        p = cifar._tar(data_dir, "cifar-10-python.tar.gz")
        if p:
            return cifar.reader_creator(p, "data_batch")
        return _synthetic_classification(n, (3, 32, 32), 10, seed)

    @staticmethod
    def test10(n=10000, seed=8, data_dir=None):
        p = cifar._tar(data_dir, "cifar-10-python.tar.gz")
        if p:
            return cifar.reader_creator(p, "test_batch")
        return _synthetic_classification(n, (3, 32, 32), 10, seed)

    @staticmethod
    def train100(n=50000, seed=2, data_dir=None):
        p = cifar._tar(data_dir, "cifar-100-python.tar.gz")
        if p:
            return cifar.reader_creator(p, "train")
        return _synthetic_classification(n, (3, 32, 32), 100, seed)


class flowers:
    """Oxford 102 Flowers (dataset/flowers.py): 102flowers.tgz of
    jpg_XXXXX.jpg images + imagelabels.mat (1-based labels) +
    setid.mat whose trnid/tstid/valid vectors hold 1-based image
    indices per split (flowers.py:110-115).  Yields (CHW float32
    in [0,1] resized 224x224, 0-based label)."""

    @staticmethod
    def _files(data_dir):
        if data_dir is None:
            data_dir = _dataset_home("flowers")
        if data_dir is None:
            return None
        paths = [os.path.join(data_dir, f) for f in
                 ("102flowers.tgz", "imagelabels.mat", "setid.mat")]
        return paths if all(os.path.exists(p) for p in paths) else None

    @staticmethod
    def reader_creator(tgz, label_mat, setid_mat, split,
                       is_train=False, seed=0):
        import io

        import scipy.io as scio

        # ONE augmentation stream across epochs: reseeding inside
        # reader() would give every epoch identical "random" crops
        rng = np.random.RandomState(seed)

        def reader():
            from PIL import Image

            from .image import simple_transform
            labels = scio.loadmat(label_mat)["labels"][0]
            idxs = scio.loadmat(setid_mat)[split][0]
            wanted = {"image_%05d.jpg" % i: int(i) for i in idxs}
            seen = 0
            # ONE forward pass over the gzip stream, yielding split
            # members in ARCHIVE order — random access on a 'r:gz' tar
            # re-inflates from byte 0 per backward seek (~N full
            # decompressions per epoch on the real 330 MB archive).
            # Order divergence vs the reference's index order is
            # documented; shuffle in the reader pipeline as usual.
            with tarfile.open(tgz) as t:
                for m in t:
                    i = wanted.get(os.path.basename(m.name))
                    if i is None:
                        continue
                    seen += 1
                    raw = t.extractfile(m).read()
                    im = np.asarray(
                        Image.open(io.BytesIO(raw)).convert("RGB"),
                        np.float32) / 255.0
                    # train: random crop + flip (the reference
                    # train_mapper); eval: center crop
                    im = simple_transform(im, 256, 224,
                                          is_train=is_train, rng=rng)
                    yield im.astype(np.float32), int(labels[i - 1]) - 1
            if seen != len(wanted):
                raise IOError(
                    f"flowers: {len(wanted) - seen} of {len(wanted)} "
                    f"{split} images missing from {tgz!r}")

        return reader

    @staticmethod
    def train(n=6149, seed=3, data_dir=None):
        real = flowers._files(data_dir)
        if real:
            return flowers.reader_creator(*real, split="trnid",
                                          is_train=True, seed=seed)
        return _synthetic_classification(n, (3, 224, 224), 102, seed)

    @staticmethod
    def test(n=1020, seed=9, data_dir=None):
        real = flowers._files(data_dir)
        if real:
            return flowers.reader_creator(*real, split="tstid")
        return _synthetic_classification(n, (3, 224, 224), 102, seed)

    @staticmethod
    def valid(n=1020, seed=10, data_dir=None):
        real = flowers._files(data_dir)
        if real:
            return flowers.reader_creator(*real, split="valid")
        return _synthetic_classification(n, (3, 224, 224), 102, seed)


class uci_housing:
    """13 features → scalar price (dataset/uci_housing.py)."""

    FEATURE_NUM = 14

    @staticmethod
    def load_data(filename, feature_num=14, ratio=0.8):
        """Parse the REAL whitespace table and normalize exactly like
        the reference (uci_housing.py:68): per-feature
        (x - avg) / (max - min) on the 13 inputs, 80/20 split."""
        data = np.fromfile(filename, sep=" ")
        data = data.reshape(data.shape[0] // feature_num, feature_num)
        maxs, mins = data.max(axis=0), data.min(axis=0)
        avgs = data.sum(axis=0) / data.shape[0]
        for i in range(feature_num - 1):
            data[:, i] = (data[:, i] - avgs[i]) / (maxs[i] - mins[i])
        offset = int(data.shape[0] * ratio)
        return data[:offset], data[offset:]

    @staticmethod
    def _real_reader(data_dir, part):
        if data_dir is None:
            data_dir = _dataset_home("uci_housing")
        if data_dir is None:
            return None
        p = os.path.join(data_dir, "housing.data")
        if not os.path.exists(p):
            return None
        tr, te = uci_housing.load_data(p)
        rows = tr if part == "train" else te

        def reader():
            for row in rows:
                yield (row[:-1].astype(np.float32),
                       np.asarray([row[-1]], np.float32))

        return reader

    @staticmethod
    def train(n=404, seed=4, data_dir=None):
        real = uci_housing._real_reader(data_dir, "train")
        if real:
            return real
        rng = np.random.RandomState(seed)
        w = rng.randn(13).astype(np.float32)

        def reader():
            r = np.random.RandomState(seed + 1)
            for _ in range(n):
                x = r.randn(13).astype(np.float32)
                y = float(x @ w + 0.1 * r.randn())
                yield x, np.asarray([y], np.float32)

        return reader

    @staticmethod
    def test(n=404, seed=4, data_dir=None):
        real = uci_housing._real_reader(data_dir, "test")
        if real:
            return real
        # forward the SAME data_dir: a typo'd explicit dir must not
        # re-resolve the env home and hand back real train data
        return uci_housing.train(n, seed, data_dir=data_dir)


class imdb:
    """Variable-length token sequences, binary sentiment
    (dataset/imdb.py)."""

    word_dict_size = 5147
    TAR = "aclImdb_v1.tar.gz"

    # -- real-format path (dataset/imdb.py tokenize/build_dict/
    # reader_creator over the aclImdb tar: pos label 0, neg label 1) --
    @staticmethod
    def tokenize(tar_path, pattern):
        import re
        import string

        rx = re.compile(pattern)
        with tarfile.open(tar_path) as tarf:
            for tf in tarf:
                if rx.match(tf.name):
                    text = tarf.extractfile(tf).read().rstrip(b"\n\r")
                    text = text.translate(
                        None, string.punctuation.encode("latin-1"))
                    yield text.lower().split()

    # the reference's corpus pattern/cutoff (dataset/imdb.py word_dict):
    # labeled train+test docs only (unsup/ and urls_*.txt excluded),
    # words kept above 150 occurrences
    DICT_PATTERN = r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$"

    @staticmethod
    def build_dict(tar_path, pattern=DICT_PATTERN, cutoff=150):
        freq: dict = {}
        for doc in imdb.tokenize(tar_path, pattern):
            for w in doc:
                freq[w] = freq.get(w, 0) + 1
        words = sorted((w for w, c in freq.items() if c > cutoff),
                       key=lambda w: (-freq[w], w))
        idx = {w: i for i, w in enumerate(words)}
        idx[b"<unk>"] = len(idx)
        return idx

    @staticmethod
    def reader_creator(tar_path, pos_pattern, neg_pattern, word_idx):
        unk = word_idx[b"<unk>"]

        def reader():
            for pattern, label in ((pos_pattern, 0), (neg_pattern, 1)):
                for doc in imdb.tokenize(tar_path, pattern):
                    yield [word_idx.get(w, unk) for w in doc], label

        return reader

    @staticmethod
    def _tar(data_dir):
        return _find_archive(data_dir, "imdb", (imdb.TAR,))

    @staticmethod
    def word_dict(data_dir=None):
        p = imdb._tar(data_dir)
        if p:
            return imdb.build_dict(p)
        return {i: i for i in range(imdb.word_dict_size)}

    @staticmethod
    def train(word_dict=None, n=25000, seed=5, max_len=200,
              data_dir=None):
        p = imdb._tar(data_dir)
        if p:
            if word_dict is None:
                word_dict = imdb.build_dict(p)
            return imdb.reader_creator(
                p, r"aclImdb/train/pos/.*\.txt$",
                r"aclImdb/train/neg/.*\.txt$", word_dict)
        vocab = imdb.word_dict_size

        def reader():
            r = np.random.RandomState(seed)
            for _ in range(n):
                length = int(r.randint(10, max_len))
                label = int(r.randint(2))
                # class-dependent token bias so models can actually learn
                lo = 0 if label == 0 else vocab // 2
                tokens = r.randint(lo, lo + vocab // 2,
                                   size=(length,)).astype(np.int64)
                yield tokens, label

        return reader

    @staticmethod
    def test(word_dict=None, n=25000, seed=11, max_len=200,
             data_dir=None):
        p = imdb._tar(data_dir)
        if p:
            if word_dict is None:
                word_dict = imdb.build_dict(p)
            return imdb.reader_creator(
                p, r"aclImdb/test/pos/.*\.txt$",
                r"aclImdb/test/neg/.*\.txt$", word_dict)
        # no real tar found for THIS data_dir: fall back to synthetic
        # without re-resolving the env home (a typo'd explicit dir must
        # not silently hand back real train data as the test set)
        return imdb.train(word_dict, n, seed, max_len,
                          data_dir=data_dir)


class imikolov:
    """PTB n-gram LM windows (dataset/imikolov.py): simple-examples.tgz
    holding ./simple-examples/data/ptb.{train,valid}.txt.  The dict is
    built from train+valid counts, words with freq > min_word_freq
    sorted by (-freq, word), '<unk>' appended LAST (imikolov.py:53-80);
    NGRAM mode yields n-windows over <s> line <e>, SEQ mode yields
    (<s>+ids, ids+<e>) pairs dropping lines longer than n
    (imikolov.py:83-109)."""

    NGRAM, SEQ = "NGRAM", "SEQ"
    TRAIN = "./simple-examples/data/ptb.train.txt"
    VALID = "./simple-examples/data/ptb.valid.txt"

    @staticmethod
    def _tar(data_dir):
        return _find_archive(
            data_dir, "imikolov",
            ("simple-examples.tgz", "simple-examples.tar.gz"))

    @staticmethod
    def _member(tf, name):
        # tar member names may or may not carry the leading "./"
        try:
            return tf.extractfile(name)
        except KeyError:
            return tf.extractfile(name[2:])

    @staticmethod
    def build_dict(min_word_freq=50, data_dir=None):
        tp = imikolov._tar(data_dir)
        if tp is None:
            # zero-egress fallback: fixed-size synthetic id space
            return {i: i for i in range(2073)}
        from collections import Counter

        freq = Counter()
        with tarfile.open(tp) as tf:
            for member in (imikolov.TRAIN, imikolov.VALID):
                for line in imikolov._member(tf, member):
                    words = line.decode("utf-8").strip().split()
                    freq.update(["<s>", "<e>"] + words)
        freq.pop("<unk>", None)
        kept = sorted(
            (x for x in freq.items() if x[1] > min_word_freq),
            key=lambda x: (-x[1], x[0]))
        word_idx = {w: i for i, (w, _c) in enumerate(kept)}
        word_idx["<unk>"] = len(word_idx)
        return word_idx

    @staticmethod
    def reader_creator(tar_path, member, word_idx, n, data_type):
        def reader():
            unk = word_idx["<unk>"]
            with tarfile.open(tar_path) as tf:
                for line in imikolov._member(tf, member):
                    words = line.decode("utf-8").strip().split()
                    if data_type == imikolov.NGRAM:
                        l = ["<s>"] + words + ["<e>"]
                        if len(l) >= n:
                            ids = [word_idx.get(w, unk) for w in l]
                            for i in range(n, len(ids) + 1):
                                yield tuple(ids[i - n:i])
                    elif data_type == imikolov.SEQ:
                        ids = [word_idx.get(w, unk) for w in words]
                        src = [word_idx.get("<s>", unk)] + ids
                        if n > 0 and len(src) > n:
                            continue
                        yield src, ids + [word_idx.get("<e>", unk)]
                    else:
                        raise ValueError(
                            f"imikolov: unknown data_type {data_type!r}")

        return reader

    @staticmethod
    def _creator(member, word_dict, n, data_type, data_dir, samples,
                 seed):
        data_type = data_type or imikolov.NGRAM
        tp = imikolov._tar(data_dir)
        if tp is not None:
            wd = word_dict or imikolov.build_dict(data_dir=data_dir)
            return imikolov.reader_creator(tp, member, wd, n, data_type)
        vocab = len(word_dict) if word_dict else 2073

        def reader():
            # the zero-egress fallback must match the real path's
            # sample shape per data_type
            r = np.random.RandomState(seed)
            if data_type == imikolov.NGRAM:
                for _ in range(samples):
                    yield tuple(int(x)
                                for x in r.randint(0, vocab,
                                                   size=(max(n, 1),)))
            elif data_type == imikolov.SEQ:
                for _ in range(samples):
                    ln = int(r.randint(3, max(n, 4) if n > 0 else 12))
                    ids = [int(x) for x in r.randint(3, vocab, ln)]
                    yield [0] + ids, ids + [1]
            else:
                raise ValueError(
                    f"imikolov: unknown data_type {data_type!r}")

        return reader

    @staticmethod
    def train(word_dict=None, n=5, data_type=None, data_dir=None,
              seed=6, samples=100000):
        return imikolov._creator(imikolov.TRAIN, word_dict, n,
                                 data_type, data_dir, samples, seed)

    @staticmethod
    def test(word_dict=None, n=5, data_type=None, data_dir=None,
             seed=13, samples=10000):
        return imikolov._creator(imikolov.VALID, word_dict, n,
                                 data_type, data_dir, samples, seed)

class movielens:
    """MovieLens 1-M (dataset/movielens.py): `ml-1m.zip` holding
    movies.dat / users.dat / ratings.dat ('::'-separated, latin-1).
    Sample layout is the reference's `usr.value() + mov.value() +
    [[rating]]`:

        [user_id, gender(0=M,1=F), age_bucket_idx, job_id,
         movie_id, [category ids], [title word ids], [rating]]

    with rating scaled `* 2 - 5` (movielens.py:160) and the age mapped
    through `age_table` (movielens.py:41).  Divergence: the category /
    title-word vocabularies are SORTED for determinism (the reference
    enumerates python-set iteration order, movielens.py:132-139).
    data_dir may hold the zip or the extracted ml-1m/ files."""

    age_table = [1, 18, 25, 35, 45, 50, 56]

    @staticmethod
    def _read_members(data_dir):
        """→ {name: text lines} for movies/users/ratings, from
        ml-1m.zip or a plain directory (None when absent)."""
        import io
        import zipfile

        if data_dir is None:
            return None
        names = ("movies.dat", "users.dat", "ratings.dat")
        zp = os.path.join(data_dir, "ml-1m.zip")
        out = {}
        if os.path.exists(zp):
            with zipfile.ZipFile(zp) as z:
                for n in names:
                    with z.open(f"ml-1m/{n}") as f:
                        out[n] = io.TextIOWrapper(
                            io.BytesIO(f.read()),
                            encoding="latin-1").readlines()
            return out
        for n in names:
            p = os.path.join(data_dir, n)
            if not os.path.exists(p):
                p2 = os.path.join(data_dir, "ml-1m", n)
                p = p2 if os.path.exists(p2) else p
            if not os.path.exists(p):
                return None
            with open(p, encoding="latin-1") as f:
                out[n] = f.readlines()
        return out

    @staticmethod
    def load_meta(data_dir):
        """Parse movies.dat/users.dat → (movie_info, user_info,
        title_dict, categories_dict).  movie_info[id] = (id, [cat ids],
        [title word ids]); user_info[id] = (id, gender01, age_idx,
        job)."""
        import re

        members = movielens._read_members(data_dir)
        if members is None:
            raise IOError(
                f"movielens: no ml-1m.zip or *.dat under {data_dir!r} "
                f"(pass data_dir= or set $PADDLE_DATASET_HOME)")
        return movielens._parse_meta(members)

    @staticmethod
    def _parse_meta(members):
        import re
        pattern = re.compile(r"^(.*)\((\d+)\)$")
        raw_movies = []
        title_words, categories = set(), set()
        for line in members["movies.dat"]:
            if not line.strip():
                continue
            mid, title, cats = line.strip().split("::")
            cats = cats.split("|")
            m = pattern.match(title)
            title = m.group(1) if m else title
            words = [w.lower() for w in title.split()]
            raw_movies.append((int(mid), cats, words))
            title_words.update(words)
            categories.update(cats)
        title_dict = {w: i for i, w in enumerate(sorted(title_words))}
        cat_dict = {c: i for i, c in enumerate(sorted(categories))}
        movie_info = {
            mid: (mid, [cat_dict[c] for c in cats],
                  [title_dict[w] for w in words])
            for mid, cats, words in raw_movies
        }
        user_info = {}
        for line in members["users.dat"]:
            if not line.strip():
                continue
            uid, gender, age, job = line.strip().split("::")[:4]
            user_info[int(uid)] = (
                int(uid), 0 if gender == "M" else 1,
                movielens.age_table.index(int(age)), int(job))
        return movie_info, user_info, title_dict, cat_dict

    @staticmethod
    def reader_creator(data_dir, is_test=False, test_ratio=0.1,
                       rand_seed=0):
        # parse the archive ONCE, lazily at first use, shared by every
        # epoch's reader() call (the real ml-1m is ~24 MB; re-parsing
        # per epoch would dominate data time)
        cache = []

        def reader():
            if not cache:
                members = movielens._read_members(data_dir)
                if members is None:
                    raise IOError(
                        f"movielens: no ml-1m.zip or *.dat under "
                        f"{data_dir!r}")
                movie_info, user_info, _, _ = \
                    movielens._parse_meta(members)
                cache.append((members["ratings.dat"], movie_info,
                              user_info))
            ratings, movie_info, user_info = cache[0]
            r = np.random.RandomState(rand_seed)
            for line in ratings:
                if not line.strip():
                    continue
                take = (r.random_sample() < test_ratio) == is_test
                if not take:
                    continue
                uid, mid, rating = line.strip().split("::")[:3]
                usr = user_info[int(uid)]
                mov = movie_info[int(mid)]
                yield (list(usr) + [mov[0], mov[1], mov[2]]
                       + [[float(rating) * 2 - 5.0]])

        return reader

    @staticmethod
    def _dir(data_dir):
        return data_dir or _dataset_home("movielens")

    @staticmethod
    def _present(data_dir):
        """Cheap existence probe (no archive read)."""
        if data_dir is None:
            return False
        if os.path.exists(os.path.join(data_dir, "ml-1m.zip")):
            return True
        return all(
            os.path.exists(os.path.join(data_dir, n))
            or os.path.exists(os.path.join(data_dir, "ml-1m", n))
            for n in ("movies.dat", "users.dat", "ratings.dat"))

    @staticmethod
    def _synthetic(n, seed, user_vocab=100, movie_vocab=200):
        def reader():
            r = np.random.RandomState(seed)
            for _ in range(n):
                uid = int(r.randint(1, user_vocab))
                mid = int(r.randint(1, movie_vocab))
                cats = [int(c) for c in r.randint(0, 18, r.randint(1, 4))]
                title = [int(t) for t in r.randint(0, 500,
                                                   r.randint(1, 8))]
                rating = float((uid + mid) % 5 + 1) * 2 - 5.0
                yield [uid, int(r.randint(0, 2)), int(r.randint(0, 7)),
                       int(r.randint(0, 21)), mid, cats, title,
                       [rating]]

        return reader

    @staticmethod
    def train(n=9000, seed=14, data_dir=None, test_ratio=0.1):
        d = movielens._dir(data_dir)
        if movielens._present(d):
            return movielens.reader_creator(d, is_test=False,
                                            test_ratio=test_ratio)
        return movielens._synthetic(n, seed)

    @staticmethod
    def test(n=1000, seed=15, data_dir=None, test_ratio=0.1):
        d = movielens._dir(data_dir)
        if movielens._present(d):
            return movielens.reader_creator(d, is_test=True,
                                            test_ratio=test_ratio)
        return movielens._synthetic(n, seed)

    @staticmethod
    def max_user_id(data_dir=None):
        _, u, _, _ = movielens.load_meta(movielens._dir(data_dir))
        return max(u)

    @staticmethod
    def max_movie_id(data_dir=None):
        m, _, _, _ = movielens.load_meta(movielens._dir(data_dir))
        return max(m)

    @staticmethod
    def max_job_id(data_dir=None):
        _, u, _, _ = movielens.load_meta(movielens._dir(data_dir))
        return max(v[3] for v in u.values())

    @staticmethod
    def get_movie_title_dict(data_dir=None):
        _, _, t, _ = movielens.load_meta(movielens._dir(data_dir))
        return t

    @staticmethod
    def movie_categories(data_dir=None):
        _, _, _, c = movielens.load_meta(movielens._dir(data_dir))
        return sorted(c)

    @staticmethod
    def batches_for_model(reader, batch_size, title_len=12):
        """Adapt raw movielens samples to models/recommender.py feeds:
        titles pad/truncate to `title_len` with a companion seq_len,
        category list is pooled away (the model's movie tower consumes
        id + title only, like the reference book test)."""

        def gen():
            buf = []
            for s in reader():
                buf.append(s)
                if len(buf) == batch_size:
                    yield movielens._to_feed(buf, title_len)
                    buf = []

        return gen

    @staticmethod
    def _to_feed(buf, title_len):
        b = len(buf)
        title = np.zeros((b, title_len), np.int64)
        tlen = np.zeros((b,), np.int32)
        for i, s in enumerate(buf):
            words = s[6][:title_len]
            title[i, :len(words)] = words
            tlen[i] = max(1, len(words))
        col = lambda j, dt: np.asarray([s[j] for s in buf],
                                       dt).reshape(b, 1)
        return {
            "user_id": col(0, np.int64),
            "gender_id": col(1, np.int64),
            "age_id": col(2, np.int64),
            "job_id": col(3, np.int64),
            "movie_id": col(4, np.int64),
            "title_ids": title,
            "title_ids.seq_len": tlen,
            "score": np.asarray([s[7][0] for s in buf],
                                np.float32).reshape(b, 1),
        }

class wmt14:
    """WMT14 en→fr subset (dataset/wmt14.py): a tar holding
    `*/src.dict`, `*/trg.dict` (one token per line, line number = id)
    and tab-separated parallel text under `train/train`, `test/test`.
    Sample = (src_ids with <s>/<e> framing, <s>+trg_ids,
    trg_ids+<e>); pairs with either side >80 tokens are dropped
    (wmt14.py:107) and OOV maps to UNK_IDX=2 (wmt14.py:53)."""

    START, END, UNK = "<s>", "<e>", "<unk>"
    UNK_IDX = 2

    @staticmethod
    def _tar(data_dir):
        return _find_archive(data_dir, "wmt14",
                             ("wmt14.tgz", "wmt14.tar.gz", "wmt14.tar"))

    @staticmethod
    def _dicts(tar_path, dict_size):
        def to_dict(fd, size):
            return {line.decode("utf-8").strip(): i
                    for i, line in enumerate(fd) if i < size}

        with tarfile.open(tar_path) as f:
            src = [m.name for m in f if m.name.endswith("src.dict")]
            trg = [m.name for m in f if m.name.endswith("trg.dict")]
            if len(src) != 1 or len(trg) != 1:
                raise IOError(
                    f"wmt14: expected exactly one src.dict and one "
                    f"trg.dict in {tar_path!r}")
            return (to_dict(f.extractfile(src[0]), dict_size),
                    to_dict(f.extractfile(trg[0]), dict_size))

    @staticmethod
    def reader_creator(tar_path, file_name, dict_size):
        cache = []  # dicts parsed once, shared by every epoch

        def reader():
            if not cache:
                cache.append(wmt14._dicts(tar_path, dict_size))
            src_dict, trg_dict = cache[0]
            with tarfile.open(tar_path) as f:
                names = [m.name for m in f
                         if m.name.endswith(file_name)]
                for name in names:
                    for line in f.extractfile(name):
                        parts = line.decode("utf-8").strip().split("\t")
                        if len(parts) != 2:
                            continue
                        src_ids = [src_dict.get(w, wmt14.UNK_IDX)
                                   for w in ([wmt14.START]
                                             + parts[0].split()
                                             + [wmt14.END])]
                        trg_ids = [trg_dict.get(w, wmt14.UNK_IDX)
                                   for w in parts[1].split()]
                        if len(src_ids) > 80 or len(trg_ids) > 80:
                            continue
                        yield (src_ids,
                               [trg_dict[wmt14.START]] + trg_ids,
                               trg_ids + [trg_dict[wmt14.END]])

        return reader

    @staticmethod
    def _synthetic(dict_size, n, seed):
        def reader():
            r = np.random.RandomState(seed)
            for _ in range(n):
                ln = int(r.randint(4, 12))
                body = r.randint(3, dict_size, ln)
                src = [0] + [int(x) for x in body] + [1]
                # learnable structure: trg token = succ(src token),
                # wrapped past the 3 reserved ids
                trg = [3 + (int(x) - 2) % (dict_size - 3) for x in body]
                yield src, [0] + trg, trg + [1]

        return reader

    @staticmethod
    def train(dict_size, data_dir=None, n=2000, seed=16):
        tp = wmt14._tar(data_dir)
        if tp:
            return wmt14.reader_creator(tp, "train/train", dict_size)
        return wmt14._synthetic(dict_size, n, seed)

    @staticmethod
    def test(dict_size, data_dir=None, n=200, seed=17):
        tp = wmt14._tar(data_dir)
        if tp:
            return wmt14.reader_creator(tp, "test/test", dict_size)
        return wmt14._synthetic(dict_size, n, seed)

    @staticmethod
    def get_dict(dict_size, reverse=True, data_dir=None):
        tp = wmt14._tar(data_dir)
        if tp is None:
            raise IOError("wmt14.get_dict needs the real tar "
                          "(data_dir= or $PADDLE_DATASET_HOME)")
        src, trg = wmt14._dicts(tp, dict_size)
        if reverse:
            src = {i: w for w, i in src.items()}
            trg = {i: w for w, i in trg.items()}
        return src, trg


class wmt16:
    """WMT16 en↔de multimodal subset (dataset/wmt16.py): a tar holding
    tab-separated `wmt16/train|val|test` (en \\t de).  Vocabularies are
    built from the TRAIN split by descending frequency with <s>, <e>,
    <unk> reserved as ids 0/1/2 (wmt16.py:63-84, built in memory here
    instead of cached dict files); both sides frame with <s>/<e> ids
    from the source dict (same indices in both, wmt16.py:119-122);
    src_lang 'en' or 'de' picks the column."""

    START, END, UNK = "<s>", "<e>", "<unk>"

    @staticmethod
    def _tar(data_dir):
        return _find_archive(data_dir, "wmt16",
                             ("wmt16.tar.gz", "wmt16.tgz", "wmt16.tar"))

    @staticmethod
    def build_dict(tar_path, dict_size, lang):
        from collections import defaultdict

        freq = defaultdict(int)
        with tarfile.open(tar_path) as f:
            for line in f.extractfile("wmt16/train"):
                parts = line.decode("utf-8").strip().split("\t")
                if len(parts) != 2:
                    continue
                sen = parts[0] if lang == "en" else parts[1]
                for w in sen.split():
                    freq[w] += 1
        words = [wmt16.START, wmt16.END, wmt16.UNK]
        # descending frequency; ties broken by insertion order like the
        # reference's sorted(iteritems, key=count)
        for w, _c in sorted(freq.items(), key=lambda kv: kv[1],
                            reverse=True):
            if len(words) == dict_size:
                break
            words.append(w)
        return {w: i for i, w in enumerate(words)}

    @staticmethod
    def reader_creator(tar_path, file_name, src_dict_size,
                       trg_dict_size, src_lang):
        cache = []  # vocab built once (two full train-split scans),
        # shared by every epoch's reader() call

        def reader():
            if not cache:
                trg_lang = "de" if src_lang == "en" else "en"
                cache.append((
                    wmt16.build_dict(tar_path, src_dict_size, src_lang),
                    wmt16.build_dict(tar_path, trg_dict_size,
                                     trg_lang)))
            src_dict, trg_dict = cache[0]
            start, end, unk = (src_dict[wmt16.START],
                               src_dict[wmt16.END],
                               src_dict[wmt16.UNK])
            src_col = 0 if src_lang == "en" else 1
            with tarfile.open(tar_path) as f:
                for line in f.extractfile(file_name):
                    parts = line.decode("utf-8").strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src_ids = ([start]
                               + [src_dict.get(w, unk)
                                  for w in parts[src_col].split()]
                               + [end])
                    trg_ids = [trg_dict.get(w, unk)
                               for w in parts[1 - src_col].split()]
                    yield (src_ids, [start] + trg_ids, trg_ids + [end])

        return reader

    @staticmethod
    def _creator(split, src_dict_size, trg_dict_size, src_lang,
                 data_dir, n, seed):
        if src_lang not in ("en", "de"):
            raise ValueError(f"wmt16: src_lang must be 'en' or 'de', "
                             f"got {src_lang!r}")
        tp = wmt16._tar(data_dir)
        if tp:
            return wmt16.reader_creator(tp, f"wmt16/{split}",
                                        src_dict_size, trg_dict_size,
                                        src_lang)
        return wmt14._synthetic(min(src_dict_size, trg_dict_size), n,
                                seed)

    @staticmethod
    def train(src_dict_size, trg_dict_size, src_lang="en",
              data_dir=None, n=2000, seed=18):
        return wmt16._creator("train", src_dict_size, trg_dict_size,
                              src_lang, data_dir, n, seed)

    @staticmethod
    def test(src_dict_size, trg_dict_size, src_lang="en",
             data_dir=None, n=200, seed=19):
        return wmt16._creator("test", src_dict_size, trg_dict_size,
                              src_lang, data_dir, n, seed)

    @staticmethod
    def validation(src_dict_size, trg_dict_size, src_lang="en",
                   data_dir=None, n=200, seed=20):
        return wmt16._creator("val", src_dict_size, trg_dict_size,
                              src_lang, data_dir, n, seed)


def padded_nmt_batches(reader, batch_size, max_src_len, max_trg_len,
                       drop_too_long=True):
    """Adapt (src_ids, trg_ids, trg_next_ids) NMT samples (wmt14/wmt16)
    to models/machine_translation.seq_to_seq_net feeds: pad to the
    static max lengths with companion seq_len vars (the padded+seq_len
    replacement for the reference's LoD batching, SURVEY.md §5.7).
    drop_too_long=False TRUNCATES over-length samples instead of
    dropping them."""

    def gen():
        buf = []
        for src, trg, nxt in reader():
            if drop_too_long and (len(src) > max_src_len
                                  or len(trg) > max_trg_len):
                continue
            buf.append((src, trg, nxt))
            if len(buf) == batch_size:
                yield _nmt_feed(buf, max_src_len, max_trg_len)
                buf = []

    return gen


def _nmt_feed(buf, max_src_len, max_trg_len):
    b = len(buf)
    src = np.zeros((b, max_src_len), np.int64)
    trg = np.zeros((b, max_trg_len), np.int64)
    nxt = np.zeros((b, max_trg_len), np.int64)
    slen = np.zeros((b,), np.int32)
    tlen = np.zeros((b,), np.int32)
    for i, (s, t, nx) in enumerate(buf):
        s, t = s[:max_src_len], t[:max_trg_len]
        nx = nx[:max_trg_len]
        src[i, :len(s)] = s
        trg[i, :len(t)] = t
        nxt[i, :len(nx)] = nx
        slen[i], tlen[i] = len(s), len(t)
    return {"src_word_id": src, "src_word_id.seq_len": slen,
            "trg_word_id": trg, "trg_word_id.seq_len": tlen,
            "trg_next_id": nxt}

class conll05:
    """CoNLL-2005 SRL (dataset/conll05.py): a tarball holding gzipped
    parallel `words` / `props` members (one token per line, blank line
    = sentence break).  Props columns are bracket-tagged spans parsed
    to B-/I-/O labels (conll05.py:108-133); one sample PER PREDICATE:

        (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2,
         pred_ids, mark, label_ids)

    where the five ctx slots broadcast the predicate-window words over
    the sentence, `mark` flags the window positions, and OOV maps to
    UNK_IDX=0 (conll05.py:150-200).  Dicts load from plain text files
    (one entry per line); the label dict derives classes from B-/I-
    prefixes (conll05.py:54-70), SORTED here for determinism (the
    reference enumerates set order)."""

    UNK_IDX = 0
    WORDS_MEMBER = "conll05st-release/test.wsj/words/test.wsj.words.gz"
    PROPS_MEMBER = "conll05st-release/test.wsj/props/test.wsj.props.gz"

    @staticmethod
    def load_dict(path):
        with open(path) as f:
            return {line.strip(): i for i, line in enumerate(f)
                    if line.strip()}

    @staticmethod
    def load_label_dict(path):
        tags = set()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line.startswith(("B-", "I-")):
                    tags.add(line[2:])
        d = {}
        for tag in sorted(tags):
            d["B-" + tag] = len(d)
            d["I-" + tag] = len(d)
        d["O"] = len(d)
        return d

    @staticmethod
    def corpus_reader(tar_path, words_name=WORDS_MEMBER,
                      props_name=PROPS_MEMBER):
        """Yield (sentence words, predicate word, BIO labels) per
        predicate column."""

        def parse_props_column(col):
            lbl_seq, cur, inside = [], "O", False
            for l in col:
                if l == "*" and not inside:
                    lbl_seq.append("O")
                elif l == "*" and inside:
                    lbl_seq.append("I-" + cur)
                elif l == "*)":
                    lbl_seq.append("I-" + cur)
                    inside = False
                elif "(" in l and ")" in l:
                    cur = l[1:l.find("*")]
                    lbl_seq.append("B-" + cur)
                    inside = False
                elif "(" in l:
                    cur = l[1:l.find("*")]
                    lbl_seq.append("B-" + cur)
                    inside = True
                else:
                    raise IOError(f"conll05: unexpected prop tag {l!r}")
            return lbl_seq

        def flush(sentence, seg):
            if seg:
                cols = list(zip(*seg))
                verbs = [v for v in cols[0] if v != "-"]
                for i, col in enumerate(cols[1:]):
                    yield (list(sentence), verbs[i],
                           parse_props_column(list(col)))

        def reader():
            with tarfile.open(tar_path) as tf:
                wf = gzip.GzipFile(fileobj=tf.extractfile(words_name))
                pf = gzip.GzipFile(fileobj=tf.extractfile(props_name))
                sentence, seg = [], []
                for wline, pline in zip(wf, pf):
                    word = wline.decode("utf-8").strip()
                    props = pline.decode("utf-8").strip().split()
                    if not props:  # sentence boundary
                        yield from flush(sentence, seg)
                        sentence, seg = [], []
                    else:
                        sentence.append(word)
                        seg.append(props)
                # a file ending at EOF without a trailing blank line
                # must not drop its last sentence
                yield from flush(sentence, seg)

        return reader

    @staticmethod
    def reader_creator(corpus_reader, word_dict, predicate_dict,
                       label_dict):
        def reader():
            for sentence, predicate, labels in corpus_reader():
                n = len(sentence)
                v = labels.index("B-V")
                mark = [0] * n
                ctx = {}
                for off, name in ((-2, "n2"), (-1, "n1"), (0, "0"),
                                  (1, "p1"), (2, "p2")):
                    j = v + off
                    if 0 <= j < n:
                        mark[j] = 1
                        ctx[name] = sentence[j]
                    else:
                        ctx[name] = "bos" if off < 0 else "eos"
                get = lambda w: word_dict.get(w, conll05.UNK_IDX)
                yield (
                    [get(w) for w in sentence],
                    [get(ctx["n2"])] * n, [get(ctx["n1"])] * n,
                    [get(ctx["0"])] * n, [get(ctx["p1"])] * n,
                    [get(ctx["p2"])] * n,
                    [predicate_dict[predicate]] * n,
                    mark,
                    [label_dict[l] for l in labels],
                )

        return reader

    @staticmethod
    def _files(data_dir):
        if data_dir is None:
            data_dir = _dataset_home("conll05st")
        if data_dir is None:
            return None
        paths = [os.path.join(data_dir, f) for f in
                 ("conll05st-tests.tar.gz", "wordDict.txt",
                  "verbDict.txt", "targetDict.txt")]
        return paths if all(os.path.exists(p) for p in paths) else None

    @staticmethod
    def get_dict(data_dir=None):
        files = conll05._files(data_dir)
        if files is None:
            raise IOError(
                "conll05.get_dict needs conll05st-tests.tar.gz + "
                "wordDict/verbDict/targetDict.txt (data_dir= or "
                "$PADDLE_DATASET_HOME/conll05st)")
        _tar, wd, vd, td = files
        return (conll05.load_dict(wd), conll05.load_dict(vd),
                conll05.load_label_dict(td))

    @staticmethod
    def _synthetic(n, seed, vocab=200, n_labels=9):
        def reader():
            r = np.random.RandomState(seed)
            for _ in range(n):
                ln = int(r.randint(4, 12))
                sent = [int(x) for x in r.randint(1, vocab, ln)]
                v = int(r.randint(0, ln))
                mark = [0] * ln
                for j in range(max(0, v - 2), min(ln, v + 3)):
                    mark[j] = 1
                lbl = [int(x) for x in r.randint(0, n_labels, ln)]
                yield (sent, [sent[max(v - 2, 0)]] * ln,
                       [sent[max(v - 1, 0)]] * ln, [sent[v]] * ln,
                       [sent[min(v + 1, ln - 1)]] * ln,
                       [sent[min(v + 2, ln - 1)]] * ln,
                       [int(r.randint(0, 50))] * ln, mark, lbl)

        return reader

    @staticmethod
    def test(n=500, seed=21, data_dir=None):
        """The reference trains on the freely-available TEST split
        (conll05.py docstring: 'Because the training dataset is not
        free, the test dataset is used for training')."""
        files = conll05._files(data_dir)
        if files:
            tar, wd, vd, td = files
            return conll05.reader_creator(
                conll05.corpus_reader(tar), conll05.load_dict(wd),
                conll05.load_dict(vd), conll05.load_label_dict(td))
        return conll05._synthetic(n, seed)

class mq2007:
    """LETOR 4.0 MQ2007 learning-to-rank (dataset/mq2007.py): text
    lines `rel qid:N 1:v 2:v ... 46:v #docid...` (48 space-split parts
    before the comment, mq2007.py:92-103).  Queries group by qid,
    docs sort by relevance desc; query_filter drops queries whose
    relevances are ALL zero (the reference filter, mq2007.py:250 —
    note it does NOT validate the {0,1,2} label range, and a
    constant-positive query legally yields zero pairwise pairs).
    Formats: pointwise (rel, vec), pairwise (1, better_vec, worse_vec)
    over all C(n,2) ordered pairs, listwise ((n,1) rels, (n,46)
    vecs)."""

    N_FEATURES = 46

    @staticmethod
    def parse_line(text):
        comment = text.find("#")
        line = (text[:comment] if comment != -1 else text).strip()
        parts = line.split()
        if len(parts) != 2 + mq2007.N_FEATURES:
            raise IOError(
                f"mq2007: expect {2 + mq2007.N_FEATURES} space-split "
                f"parts, got {len(parts)}: {text[:60]!r}")
        rel = int(parts[0])
        qid = int(parts[1].split(":")[1])
        vec = [float(p.split(":")[1]) for p in parts[2:]]
        return rel, qid, vec

    @staticmethod
    def load_from_text(path):
        """→ list of (qid, [(rel, vec), ...]) in file order."""
        groups, order = {}, []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                rel, qid, vec = mq2007.parse_line(line)
                if qid not in groups:
                    groups[qid] = []
                    order.append(qid)
                groups[qid].append((rel, vec))
        return [(q, groups[q]) for q in order]

    FORMATS = ("pointwise", "pairwise", "listwise")

    @staticmethod
    def query_filter(groups):
        """Drop queries whose documents are ALL relevance 0 (the
        reference query_filter, mq2007.py:250 — a zero-sum querylist
        has no ranking signal)."""
        return [(q, docs) for q, docs in groups
                if sum(d[0] for d in docs) != 0]

    @staticmethod
    def _emit(docs, format):
        """One query's docs → samples for the chosen format (shared by
        the real and synthetic paths so they can never drift)."""
        docs = sorted(docs, key=lambda d: d[0], reverse=True)
        if format == "pointwise":
            for rel, vec in docs:
                yield rel, np.asarray(vec, np.float32)
        elif format == "pairwise":
            for i in range(len(docs)):
                for j in range(i + 1, len(docs)):
                    if docs[i][0] > docs[j][0]:
                        yield (np.asarray([1], np.float32),
                               np.asarray(docs[i][1], np.float32),
                               np.asarray(docs[j][1], np.float32))
        elif format == "listwise":
            yield (np.asarray([[d[0]] for d in docs], np.float32),
                   np.asarray([d[1] for d in docs], np.float32))
        else:  # pragma: no cover — _check_format guards
            raise ValueError(f"mq2007: unknown format {format!r}")

    @staticmethod
    def reader_creator(path, format="pairwise"):
        mq2007._check_format(format)

        def reader():
            for _qid, docs in mq2007.query_filter(
                    mq2007.load_from_text(path)):
                yield from mq2007._emit(docs, format)

        return reader

    @staticmethod
    def _check_format(format):
        if format not in mq2007.FORMATS:
            raise ValueError(
                f"mq2007: unknown format {format!r} (use "
                f"{'/'.join(mq2007.FORMATS)})")

    @staticmethod
    def _file(data_dir, name):
        if data_dir is None:
            data_dir = _dataset_home("MQ2007")
        if data_dir is None:
            return None
        for cand in (os.path.join(data_dir, name),
                     os.path.join(data_dir, "MQ2007", "Fold1", name)):
            if os.path.exists(cand):
                return cand
        return None

    @staticmethod
    def _synthetic(n_queries, seed, format):
        mq2007._check_format(format)

        def reader():
            r = np.random.RandomState(seed)
            for _ in range(n_queries):
                n = int(r.randint(3, 8))
                docs = [(int(r.randint(0, 3)),
                         r.randn(mq2007.N_FEATURES).tolist())
                        for _ in range(n)]
                if sum(d[0] for d in docs) == 0:
                    continue  # mirror query_filter
                yield from mq2007._emit(docs, format)

        return reader

    @staticmethod
    def train(format="pairwise", data_dir=None, n_queries=200, seed=22):
        p = mq2007._file(data_dir, "train.txt")
        if p:
            return mq2007.reader_creator(p, format)
        return mq2007._synthetic(n_queries, seed, format)

    @staticmethod
    def test(format="pairwise", data_dir=None, n_queries=40, seed=23):
        p = mq2007._file(data_dir, "test.txt")
        if p:
            return mq2007.reader_creator(p, format)
        return mq2007._synthetic(n_queries, seed, format)


class sentiment:
    """NLTK movie_reviews sentiment corpus (dataset/sentiment.py): a
    directory (or zip) of pos/*.txt and neg/*.txt reviews.  The word
    dict orders ALL corpus words by descending frequency
    (sentiment.py:56-74); samples are (word id list, 0=pos|1=neg)
    following the reference's category indexing."""

    @staticmethod
    def _root(data_dir):
        if data_dir is None:
            data_dir = _dataset_home("sentiment")
        if data_dir is None:
            return None
        for cand in (data_dir, os.path.join(data_dir, "movie_reviews")):
            if (os.path.isdir(os.path.join(cand, "pos"))
                    and os.path.isdir(os.path.join(cand, "neg"))):
                return cand
        return None

    @staticmethod
    def _tokenize(text):
        import re

        return re.findall(r"[a-z0-9']+|[^\sa-z0-9']", text.lower())

    @staticmethod
    def _iter_files(root, cat):
        d = os.path.join(root, cat)
        for name in sorted(os.listdir(d)):
            if name.endswith(".txt"):
                with open(os.path.join(d, name), encoding="latin-1") as f:
                    yield sentiment._tokenize(f.read())

    # one read+tokenize scan of the 2000-file corpus shared by
    # get_word_dict and every train/test reader, keyed by corpus root
    _corpus_cache: dict = {}

    @staticmethod
    def _load_corpus(root):
        if root not in sentiment._corpus_cache:
            from collections import Counter

            freq = Counter()
            per_cat = {}
            for cat in ("pos", "neg"):
                per_cat[cat] = list(sentiment._iter_files(root, cat))
                for words in per_cat[cat]:
                    freq.update(words)
            ranked = sorted(freq.items(), key=lambda kv: -kv[1])
            word_dict = [(w, i) for i, (w, _c) in enumerate(ranked)]
            sentiment._corpus_cache[root] = (per_cat, word_dict)
        return sentiment._corpus_cache[root]

    @staticmethod
    def get_word_dict(data_dir=None):
        """[(word, id)] ordered by descending corpus frequency (ties by
        first-seen order, matching the reference's stable sort)."""
        root = sentiment._root(data_dir)
        if root is None:
            raise IOError(
                "sentiment.get_word_dict needs a movie_reviews dir "
                "with pos/ and neg/ (data_dir= or "
                "$PADDLE_DATASET_HOME/sentiment)")
        return sentiment._load_corpus(root)[1]

    @staticmethod
    def reader_creator(data_dir, is_test, test_ratio=0.1):
        def reader():
            root = sentiment._root(data_dir)
            per_cat, word_dict = sentiment._load_corpus(root)
            ids = dict(word_dict)
            # split WITHIN each category so both splits keep the
            # pos/neg balance (a tail slice of the pos-then-neg list
            # would make the test split all-negative)
            for label, cat in enumerate(("pos", "neg")):
                docs = per_cat[cat]
                n_test = max(1, int(len(docs) * test_ratio))
                picked = docs[-n_test:] if is_test else docs[:-n_test]
                for words in picked:
                    yield [ids[w] for w in words], label

        return reader

    @staticmethod
    def _synthetic(n, seed, vocab=5000):
        def reader():
            r = np.random.RandomState(seed)
            for _ in range(n):
                ln = int(r.randint(20, 120))
                label = int(r.randint(0, 2))
                # learnable: polarity words drawn from disjoint ranges
                base = 100 + label * 200
                yield ([int(x) for x in r.randint(base, base + 200,
                                                  ln)], label)

        return reader

    @staticmethod
    def train(n=1800, seed=24, data_dir=None):
        if sentiment._root(data_dir or _dataset_home("sentiment")):
            return sentiment.reader_creator(data_dir, is_test=False)
        return sentiment._synthetic(n, seed)

    @staticmethod
    def test(n=200, seed=25, data_dir=None):
        if sentiment._root(data_dir or _dataset_home("sentiment")):
            return sentiment.reader_creator(data_dir, is_test=True)
        return sentiment._synthetic(n, seed)


class voc2012:
    """PASCAL VOC2012 segmentation (dataset/voc2012.py): the VOCdevkit
    tar with ImageSets/Segmentation/{train,val,trainval}.txt name
    lists, JPEGImages/<name>.jpg and SegmentationClass/<name>.png
    (voc2012.py:37-39).  Yields (HWC uint8 image, HW uint8 class-index
    mask) — the palette png decodes to class indices."""

    SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
    DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
    LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"

    @staticmethod
    def _tar(data_dir):
        return _find_archive(
            data_dir, "voc2012",
            ("VOCtrainval_11-May-2012.tar", "VOC2012.tar",
             "voc2012.tar"))

    @staticmethod
    def reader_creator(tar_path, sub_name):
        import io

        def reader():
            from PIL import Image

            with tarfile.open(tar_path) as t:
                names = t.extractfile(
                    voc2012.SET_FILE.format(sub_name)).read()
                for name in names.decode("utf-8").split():
                    img = t.extractfile(
                        voc2012.DATA_FILE.format(name)).read()
                    lbl = t.extractfile(
                        voc2012.LABEL_FILE.format(name)).read()
                    im = np.asarray(
                        Image.open(io.BytesIO(img)).convert("RGB"),
                        np.uint8)
                    # palette png: pixel values ARE the class indices
                    mask = np.asarray(Image.open(io.BytesIO(lbl)),
                                      np.uint8)
                    yield im, mask

        return reader

    @staticmethod
    def _synthetic(n, seed, size=64, n_classes=21):
        def reader():
            r = np.random.RandomState(seed)
            for _ in range(n):
                im = r.randint(0, 256, (size, size, 3)).astype(np.uint8)
                mask = r.randint(0, n_classes,
                                 (size, size)).astype(np.uint8)
                yield im, mask

        return reader

    @staticmethod
    def _split(sub, n, seed, data_dir):
        tp = voc2012._tar(data_dir)
        if tp:
            return voc2012.reader_creator(tp, sub)
        return voc2012._synthetic(n, seed)

    # NOTE the reference's own split mapping is train->'trainval',
    # test->'train', val->'val' (voc2012.py:69-87 — VOC's real test
    # labels are not public, so its "test" reuses the train list and
    # OVERLAPS train).  Kept verbatim for parity; use val() for an
    # untainted eval split.

    @staticmethod
    def train(n=100, seed=26, data_dir=None):
        return voc2012._split("trainval", n, seed, data_dir)

    @staticmethod
    def test(n=20, seed=27, data_dir=None):
        return voc2012._split("train", n, seed, data_dir)

    @staticmethod
    def val(n=20, seed=28, data_dir=None):
        return voc2012._split("val", n, seed, data_dir)

def padded_text_batches(reader, batch_size, max_len, drop_too_long=False):
    """Adapt (word id list, label) text-classification samples
    (sentiment / imdb) to the stacked_dynamic_lstm model feeds:
    {words (B, max_len) int64 padded, words.seq_len (B,) int32,
    label (B, 1) int64}.  Over-length samples truncate (or drop)."""

    def gen():
        buf = []
        for ids, label in reader():
            if drop_too_long and len(ids) > max_len:
                continue
            buf.append((ids[:max_len], label))
            if len(buf) == batch_size:
                words = np.zeros((batch_size, max_len), np.int64)
                lens = np.zeros((batch_size,), np.int32)
                lbl = np.zeros((batch_size, 1), np.int64)
                for i, (ids_i, y) in enumerate(buf):
                    words[i, :len(ids_i)] = ids_i
                    lens[i] = max(1, len(ids_i))
                    lbl[i, 0] = y
                yield {"words": words, "words.seq_len": lens,
                       "label": lbl}
                buf = []

    return gen


def ngram_batches(reader, batch_size, window):
    """Adapt imikolov NGRAM samples ((n,) id tuples, n = window + 1) to
    the word2vec model feeds: {context_words (B, window) int64,
    target_word (B, 1) int64} — context predicts the LAST word."""

    def gen():
        buf = []
        for gram in reader():
            if len(gram) != window + 1:
                raise ValueError(
                    f"ngram_batches(window={window}) needs "
                    f"{window + 1}-grams, got {len(gram)}")
            buf.append(gram)
            if len(buf) == batch_size:
                arr = np.asarray(buf, np.int64)
                yield {"context_words": arr[:, :window],
                       "target_word": arr[:, window:]}
                buf = []

    return gen

def srl_batches(reader, batch_size, max_length):
    """Adapt conll05 9-slot samples to the models/sequence_tagging SRL
    feeds: the 6 word-feature slots + verb + mark + target, each padded
    (B, max_length) int64 with a shared per-feature .seq_len companion.
    Over-length sentences drop (static shapes under jit)."""
    names = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2",
             "verb", "mark", "target")

    def gen():
        buf = []
        for sample in reader():
            if len(sample[0]) > max_length:
                continue
            buf.append(sample)
            if len(buf) == batch_size:
                feed = {}
                lens = np.asarray([len(s[0]) for s in buf], np.int32)
                for j, name in enumerate(names):
                    arr = np.zeros((batch_size, max_length), np.int64)
                    for i, s in enumerate(buf):
                        arr[i, :len(s[j])] = s[j]
                    feed[name] = arr
                    feed[f"{name}.seq_len"] = lens
                yield feed
                buf = []

    return gen
