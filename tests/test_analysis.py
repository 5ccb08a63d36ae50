"""Analyzer tests (reference: tests/analysis/*_stream_tests.cpp)."""

import pytest

from iresearch_tpu.analysis import get, registered
from iresearch_tpu.analysis.analyzers import (
    DelimiterAnalyzer,
    MultiDelimiterAnalyzer,
    NGramAnalyzer,
    PipelineAnalyzer,
    SegmentationAnalyzer,
    StopwordsAnalyzer,
    TextAnalyzer,
)
from iresearch_tpu.analysis.porter2 import stem


class TestPorter2:
    def test_known_vectors(self):
        vectors = {
            "running": "run",
            "generously": "generous",
            "conditional": "condit",
            "happiness": "happi",
            "flies": "fli",
            "ties": "tie",
            "cries": "cri",
            "dying": "die",
            "news": "news",
            "skies": "sky",
            "caresses": "caress",
            "hopping": "hop",
            "hoping": "hope",
            "national": "nation",
            "rational": "ration",
            "exceed": "exceed",
            "agreement": "agreement",
            "cats": "cat",
        }
        for w, expected in vectors.items():
            assert stem(w) == expected, w

    def test_matches_nltk_on_real_vocabulary(self):
        """Exact agreement with NLTK snowball on the europarl vocabulary.

        (On synthetic non-words NLTK's region bookkeeping deviates slightly
        from the published algorithm; real-text agreement is the contract.)
        """
        nltk = pytest.importorskip("nltk.stem.snowball")
        import re

        ref = nltk.EnglishStemmer()
        words = set()
        try:
            with open(
                "/root/reference/tests/resources/europarl.subset.txt", errors="ignore"
            ) as f:
                for line in f:
                    words.update(w.lower() for w in re.findall(r"[a-zA-Z']+", line))
        except FileNotFoundError:
            pytest.skip("europarl corpus not available")
        mismatches = [w for w in words if stem(w) != ref.stem(w)]
        assert mismatches == []

    def test_short_words_unchanged(self):
        for w in ["a", "is", "be", "x"]:
            assert stem(w) == w


class TestSegmentation:
    def test_basic(self):
        a = SegmentationAnalyzer()
        toks = a.tokenize("Hello, World! 42 times")
        assert [t.term for t in toks] == [b"hello", b"world", b"42", b"times"]
        assert [t.position for t in toks] == [0, 1, 2, 3]

    def test_case_modes(self):
        assert SegmentationAnalyzer(case="none").terms("AbC") == [b"AbC"]
        assert SegmentationAnalyzer(case="upper").terms("AbC") == [b"ABC"]

    def test_offsets(self):
        toks = SegmentationAnalyzer().tokenize("foo bar")
        assert (toks[0].start, toks[0].end) == (0, 3)
        assert (toks[1].start, toks[1].end) == (4, 7)

    def test_unicode(self):
        assert SegmentationAnalyzer().terms("Füße gehen") == [
            "füße".encode(), "gehen".encode()
        ]

    def test_bad_options(self):
        with pytest.raises(ValueError):
            SegmentationAnalyzer(case="wat")


class TestTextAnalyzer:
    def test_stop_and_stem(self):
        a = TextAnalyzer()
        assert a.terms("The running foxes are jumping") == [b"run", b"fox", b"jump"]

    def test_accent_removal(self):
        a = TextAnalyzer(stemming=False, stopwords=[])
        assert a.terms("café naïve") == [b"cafe", b"naive"]

    def test_custom_stopwords(self):
        a = TextAnalyzer(stopwords=["foo"], stemming=False)
        assert a.terms("foo bar") == [b"bar"]


class TestDelimiters:
    def test_delimiter(self):
        assert DelimiterAnalyzer(",").terms("a,b,,c") == [b"a", b"b", b"c"]

    def test_multi(self):
        a = MultiDelimiterAnalyzer([",", ";", "||"])
        assert a.terms("a,b;c||d") == [b"a", b"b", b"c", b"d"]

    def test_multi_requires_delims(self):
        with pytest.raises(ValueError):
            MultiDelimiterAnalyzer([])


class TestNGram:
    def test_basic(self):
        a = NGramAnalyzer(2, 3)
        toks = a.tokenize("abcd")
        terms = [t.term for t in toks]
        assert terms == [b"ab", b"abc", b"bc", b"bcd", b"cd"]
        # grams starting at the same offset share a position
        assert [t.position for t in toks] == [0, 0, 1, 1, 2]

    def test_preserve_original(self):
        a = NGramAnalyzer(2, 2, preserve_original=True)
        assert a.terms("abcd")[0] == b"abcd"

    def test_markers(self):
        a = NGramAnalyzer(2, 2, start_marker="^", end_marker="$")
        assert a.terms("abc") == [b"^ab", b"bc$"]

    def test_bounds(self):
        with pytest.raises(ValueError):
            NGramAnalyzer(0, 2)
        with pytest.raises(ValueError):
            NGramAnalyzer(3, 2)


class TestPipelineAndRegistry:
    def test_pipeline(self):
        p = PipelineAnalyzer([DelimiterAnalyzer(","), SegmentationAnalyzer()])
        assert p.terms("Big Apple,New York") == [b"big", b"apple", b"new", b"york"]

    def test_stopwords_wrapper(self):
        a = StopwordsAnalyzer(["x"], inner=SegmentationAnalyzer())
        assert a.terms("x y") == [b"y"]

    def test_registry_roundtrip(self):
        a = get("text", {"locale": "en", "stemming": False, "stopwords": []})
        assert a.terms("Walking") == [b"walking"]
        assert "segmentation" in registered()
        with pytest.raises(KeyError):
            get("nope")

    def test_registry_json_args(self):
        a = get("delimiter", '{"delimiter": ";"}')
        assert a.terms("a;b") == [b"a", b"b"]

    def test_pipeline_from_json(self):
        a = get(
            "pipeline",
            {
                "pipeline": [
                    {"type": "delimiter", "properties": {"delimiter": ","}},
                    {"type": "text", "properties": {"stemming": True, "stopwords": []}},
                ]
            },
        )
        assert a.terms("Running,Foxes") == [b"run", b"fox"]

    def test_minhash_deterministic(self):
        a = get("minhash", {"numHashes": 8})
        s1 = a.terms("the quick brown fox jumps")
        s2 = a.terms("the quick brown fox jumps")
        assert s1 == s2 and len(s1) <= 8


def test_classification_and_nearest_neighbors(tmp_path):
    """fastText-family analyzers (reference: classification_stream.hpp:37,
    nearest_neighbors_stream.hpp:38): train a tiny supervised embedding
    model in JAX, persist it, and drive both analyzers through the JSON
    registry with the reference's parameter names."""
    from iresearch_tpu.analysis import analyzers as A
    from iresearch_tpu.analysis.embed import load_model, train_supervised

    texts = [
        [b"good", b"great", b"awesome"],
        [b"bad", b"awful", b"terrible"],
        [b"great", b"nice", b"good"],
        [b"terrible", b"bad", b"poor"],
    ] * 4
    labels = [b"__label__pos", b"__label__neg"] * 8
    m = train_supervised(texts, labels, dim=8, epochs=150, buckets=1 << 12)
    (lbl, p), = m.predict([b"good", b"nice"], k=1)
    assert lbl == b"__label__pos" and p > 0.5
    (lbl2, _), = m.predict([b"awful", b"poor"], k=1)
    assert lbl2 == b"__label__neg"
    # neighbours of "good" are its co-occurring positives
    nn = [w for w, _s in m.nearest(b"good", k=2)]
    assert set(nn) <= {b"great", b"nice", b"awesome"}

    path = str(tmp_path / "model.npz")
    m.save(path)
    m2 = load_model(path)
    assert m2.predict([b"good"], k=1)[0][0] == b"__label__pos"

    clf = A.get("classification", {"model_location": path, "top_k": 1})
    assert clf.terms("a good nice day") == [b"__label__pos"]
    # threshold filters low-confidence labels
    strict = A.get(
        "classification", {"model_location": path, "top_k": 2, "threshold": 0.99}
    )
    assert len(strict.terms("good bad")) <= 1
    nna = A.get("nearest_neighbors", {"model_location": path, "top_k": 1})
    toks = nna.tokenize("good bad")
    assert len(toks) == 2
    assert toks[0].position == 0 and toks[1].position == 1


def test_classification_analyzer_indexes(tmp_path):
    """End-to-end: label tokens from the classification analyzer are
    searchable like any other field tokens."""
    from iresearch_tpu.analysis.embed import train_supervised
    from iresearch_tpu.index.reader import DirectoryReader
    from iresearch_tpu.index.writer import Field, IndexWriter, IndexWriterOptions
    from iresearch_tpu.search import filters as F
    from iresearch_tpu.search.host_eval import search
    from iresearch_tpu.store.directory import MemoryDirectory

    texts = [[b"good", b"great"], [b"bad", b"awful"]] * 6
    labels = [b"pos", b"neg"] * 6
    m = train_supervised(texts, labels, dim=8, epochs=120, buckets=1 << 12)
    path = str(tmp_path / "m.npz")
    m.save(path)

    from iresearch_tpu.analysis import analyzers as A

    clf = A.get("classification", {"model_location": path, "top_k": 1})
    d = MemoryDirectory()
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy")) as w:
        w.insert([Field("sentiment", "a good great day", analyzer=clf)])
        w.insert([Field("sentiment", "bad awful times", analyzer=clf)])
        w.commit()
    r = DirectoryReader.open(d)
    hits = search(r, F.ByTerm("sentiment", "pos"), k=5)
    assert [h[0] for h in hits] == [0]
    hits = search(r, F.ByTerm("sentiment", "neg"), k=5)
    assert [h[0] for h in hits] == [1]


def test_fasttext_bin_loader(tmp_path):
    """Write a synthetic fastText .bin (FastText::saveModel layout) and
    load it through the classification/nearest_neighbors model path
    (reference: classification_stream.hpp:37 consumes .bin models)."""
    import struct

    import numpy as np

    from iresearch_tpu.analysis.embed import (
        _ft_hash,
        load_fasttext_bin,
        load_model,
    )

    dim, bucket, minn, maxn = 4, 32, 2, 3
    words = [b"hello", b"world"]
    labels = [b"__label__a", b"__label__b"]
    rng = np.random.default_rng(0)
    inp = rng.normal(size=(len(words) + bucket, dim)).astype(np.float32)
    out = rng.normal(size=(len(labels), dim)).astype(np.float32)

    buf = bytearray()
    buf += struct.pack("<ii", 793712314, 12)  # magic, version
    buf += struct.pack(
        "<12i", dim, 5, 5, 1, 5, 1, 0, 3, bucket, minn, maxn, 100
    )  # args (model=3 supervised)
    buf += struct.pack("<d", 1e-4)
    buf += struct.pack("<3i", len(words) + len(labels), len(words), len(labels))
    buf += struct.pack("<2q", 1000, 0)  # ntokens, pruneidx_size
    for w in words:
        buf += w + b"\x00" + struct.pack("<qb", 10, 0)
    for lb in labels:
        buf += lb + b"\x00" + struct.pack("<qb", 5, 1)
    buf += b"\x00"  # quant flag
    buf += struct.pack("<2q", inp.shape[0], dim) + inp.tobytes()
    buf += b"\x00"  # qout flag
    buf += struct.pack("<2q", out.shape[0], dim) + out.tobytes()
    path = str(tmp_path / "model.bin")
    open(path, "wb").write(bytes(buf))

    m = load_fasttext_bin(path)
    assert m.vocab == words and m.labels == labels
    assert m.hash_kind == "ft32" and m.buckets == bucket
    np.testing.assert_array_equal(m.input_vectors, inp)
    # fastText's signed-char FNV32 (hash("ab") differs from unsigned FNV)
    assert _ft_hash(b"ab") == ((((2166136261 ^ 97) * 16777619)
                                % 2**32 ^ 98) * 16777619) % 2**32
    # word vector mixes the word row with its ft-hashed bucket rows
    v = m.word_vector(b"hello")
    assert v.shape == (dim,) and np.isfinite(v).all()
    assert not np.allclose(v, inp[0])  # subword rows contribute
    # top-k labels through the supervised head
    preds = m.predict([b"hello", b"world"], k=2)
    assert len(preds) == 2 and abs(sum(p for _l, p in preds) - 1.0) < 1e-5
    # the registry path auto-detects .bin by magic
    assert load_model(path) is not None

    # the classification analyzer consumes it end-to-end
    from iresearch_tpu.analysis import get as get_analyzer

    an = get_analyzer(
        "classification",
        {"model_location": path, "top_k": 1},
    )
    toks = an.tokenize("hello world")
    assert toks and toks[0].term in labels


class TestWordChars:
    """The committed word class (analysis/word_chars.py) stands in for the
    ``regex`` package's ``\\w``: same code points, same tokens."""

    def test_ranges_match_regex_w(self):
        import regex

        from iresearch_tpu.analysis.word_chars import is_word

        w = regex.compile(r"\w", regex.UNICODE)
        diff = [
            cp
            for cp in range(0x110000)
            if not 0xD800 <= cp <= 0xDFFF
            and is_word(cp) != (w.match(chr(cp)) is not None)
        ]
        assert diff == []

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_word_re_tokens_match_regex(self, seed):
        import random

        import regex

        from iresearch_tpu.analysis.analyzers import _WORD_RE

        ref = regex.compile(r"[\w'']+", regex.UNICODE)
        rnd = random.Random(seed)
        # letters, combining marks (where stdlib \w differs), digits,
        # punctuation, spaces, CJK, Hangul, emoji and join controls
        pools = [
            range(0x20, 0x7F), range(0xC0, 0x250), range(0x300, 0x370),
            range(0x591, 0x5C8), range(0x900, 0x980), range(0x2000, 0x2070),
            range(0x3040, 0x3100), range(0x4E00, 0x4E80), range(0xAC00, 0xAC80),
            range(0x1F300, 0x1F380), range(0xE0100, 0xE0110),
        ]
        text = "".join(
            chr(rnd.choice(rnd.choice(pools))) for _ in range(4000)
        )
        got = [m.span() for m in _WORD_RE.finditer(text)]
        want = [m.span() for m in ref.finditer(text)]
        assert got == want

    def test_analyzers_import_without_regex(self):
        import subprocess
        import sys

        code = (
            "import sys; sys.modules['regex'] = None; "
            "from iresearch_tpu.analysis.analyzers import SegmentationAnalyzer; "
            "print([t.term.decode() for t in "
            "SegmentationAnalyzer().tokenize('Cafe\\u0301 naïve x_y 42')])"
        )
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            check=True,
        ).stdout
        # the combining acute stays inside the word (stdlib \w drops it)
        assert out.strip() == "['cafe\u0301', 'naïve', 'x_y', '42']"

    def test_native_tables_generate_without_regex(self):
        import os
        import subprocess
        import sys

        native = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "native",
        )
        code = (
            "import sys, runpy; sys.modules['regex'] = None; "
            "runpy.run_path('gen_unicode_tables.py', run_name='__main__')"
        )
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=native, capture_output=True,
            text=True, check=True,
        ).stdout
        assert out.startswith("// generated by gen_unicode_tables.py")
        assert "u_flag_index" in out and "u_upper_data" in out
