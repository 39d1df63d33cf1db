"""The port's own copy of the BERT data pipelines (``nlp/``): the
wordpiece tokenizer, ``BertIterator`` (masked LM and sequence
classification) and ``LMSequenceIterator``, against the JAX package's,
batch for batch from the same seed — every array equal — with the
reference tests' own checks. Twins of ``tests/test_bert_iterator.py``
(``:26-156`` the tokenizer and the iterator's masking, ``:194`` the LM
packing, and the trailing-batch and truncation tests). The model half
(``:177``, the MLM head trained through the iterator) is
``tests/test_torch_mlm.py``'s.

Tolerance: none — numpy on both sides, the same draws, equal arrays.
"""
import numpy as np
import pytest

from deeplearning4j_tpu import nlp as jnlp
from deeplearning4j_tpu_torch.nlp import (BertIterator,
                                          BertWordPieceTokenizer,
                                          LMSequenceIterator,
                                          DefaultTokenizerFactory,
                                          CommonPreprocessor)
from deeplearning4j_tpu_torch.nlp.bert_iterator import (CLS, MASK, PAD,
                                                        SEP, SPECIALS, UNK)

CORPUS = ["the quick brown fox jumps over the lazy dog",
          "pack my box with five dozen liquor jugs",
          "how vexingly quick daft zebras jump",
          "the five boxing wizards jump quickly"] * 4


@pytest.fixture(scope="module")
def tok():
    return BertWordPieceTokenizer(BertWordPieceTokenizer.build_vocab(CORPUS))


@pytest.fixture(scope="module")
def jtok():
    return jnlp.BertWordPieceTokenizer(
        jnlp.BertWordPieceTokenizer.build_vocab(CORPUS))


def _same_batches(port_it, jax_it, n=None):
    """Every batch of the two iterators equal, array for array."""
    count = 0
    for p, j in zip(port_it, jax_it):
        for attr in ("features", "labels", "features_masks",
                     "labels_masks"):
            a, b = getattr(p, attr, None), getattr(j, attr, None)
            if b is None or isinstance(b, np.ndarray):
                a, b = [a], [b]
            assert len(a) == len(b), attr
            for x, y in zip(a, b):
                if y is None:
                    assert x is None, attr
                else:
                    np.testing.assert_array_equal(np.asarray(x),
                                                  np.asarray(y), attr)
                    assert np.asarray(x).dtype == np.asarray(y).dtype
        count += 1
        if n is not None and count >= n:
            break
    assert count > 0
    return count


def test_vocab_and_tokens_match_jax(tok, jtok):
    assert tok.vocab == jtok.vocab
    for text in CORPUS[:4] + ["quickest zebras", "abc xyz", "The Fox"]:
        assert tok.tokenize(text) == jtok.tokenize(text)
        assert tok.encode(text) == jtok.encode(text)


def test_wordpiece_whole_words(tok):
    assert tok.tokenize("the quick fox") == ["the", "quick", "fox"]


def test_wordpiece_decomposes_unseen_words(tok):
    pieces = tok.tokenize("quickest")
    assert pieces[0] == "quick"
    assert all(p.startswith("##") for p in pieces[1:])
    assert "".join(p.lstrip("#") for p in pieces) == "quickest"


def test_wordpiece_unknown_char_is_unk():
    t = BertWordPieceTokenizer(BertWordPieceTokenizer.build_vocab(["abc"]))
    assert t.tokenize("abc xyz") == ["abc", UNK]


def test_vocab_file_roundtrip_and_scrambled_specials(tok, tmp_path):
    """A ``vocab.txt`` saved by the port loads in both packages; a
    vocabulary whose specials sit at high ids masks the same way in
    both."""
    p = tmp_path / "vocab.txt"
    tok.save_vocab(p)
    assert BertWordPieceTokenizer.from_vocab_file(p).vocab == tok.vocab
    assert jnlp.BertWordPieceTokenizer.from_vocab_file(p).vocab == tok.vocab
    pieces = sorted(tok.vocab, key=tok.vocab.get)
    scrambled = ([w for w in pieces if w not in SPECIALS]
                 + [w for w in pieces if w in SPECIALS])
    (tmp_path / "v2.txt").write_text("\n".join(scrambled) + "\n")
    t3 = BertWordPieceTokenizer.from_vocab_file(tmp_path / "v2.txt")
    j3 = jnlp.BertWordPieceTokenizer.from_vocab_file(tmp_path / "v2.txt")
    it = BertIterator(t3, CORPUS, batch_size=4, seq_len=16, seed=21)
    _same_batches(it, jnlp.BertIterator(j3, CORPUS, batch_size=4,
                                        seq_len=16, seed=21))
    v = t3.vocab
    for mds in it:
        ids, lmask = mds.features[0], mds.labels_masks[0]
        special = np.isin(ids, [v[s] for s in SPECIALS])
        assert not (special & (lmask > 0) & (ids != v[MASK])).any()
    with pytest.raises(ValueError, match="duplicate"):
        (tmp_path / "dup.txt").write_text("a\nb\na\n")
        BertWordPieceTokenizer.from_vocab_file(tmp_path / "dup.txt")


@pytest.mark.parametrize("seed", (1, 2, 21))
@pytest.mark.parametrize("one_hot", (True, False))
def test_mask_lm_batches_equal_jax(tok, jtok, seed, one_hot):
    """The masked-LM batches, epoch after epoch (``reset`` draws fresh
    masking), equal the JAX iterator's: corrupted tokens, segments,
    one-hot or sparse labels, key masks and labels masks."""
    kw = dict(batch_size=4, seq_len=16, task="mask_lm", seed=seed,
              one_hot_labels=one_hot)
    it, jit = BertIterator(tok, CORPUS, **kw), jnlp.BertIterator(
        jtok, CORPUS, **kw)
    for _ in range(2):
        assert _same_batches(it, jit) == 4
        it.reset()
        jit.reset()


def test_mask_lm_batch_shapes_and_semantics(tok):
    it = BertIterator(tok, CORPUS, batch_size=4, seq_len=16,
                      task="mask_lm", seed=1)
    mds = next(iter(it))
    ids, segs = mds.features
    (y,), (lmask,) = mds.labels, mds.labels_masks
    assert ids.shape == (4, 16) and segs.shape == (4, 16)
    fm_tok, fm_seg = mds.features_masks
    assert (fm_tok == (ids != tok.vocab[PAD])).all()
    assert (fm_seg == fm_tok).all()
    assert y.shape == (4, 16, len(tok.vocab))
    v = tok.vocab
    assert (ids[:, 0] == v[CLS]).all()
    assert all((row == v[SEP]).any() for row in ids)
    assert (lmask.sum(axis=1) >= 1).all()
    special = np.isin(ids, [v[s] for s in SPECIALS])
    assert not (special & (lmask > 0) & (ids != v[MASK])).any()
    orig = np.argmax(y, axis=-1)
    masked_here = (ids == v[MASK]) & (lmask > 0)
    assert (orig[masked_here] != v[MASK]).all()


def test_mask_lm_corruption_statistics(tok):
    it = BertIterator(tok, CORPUS * 40, batch_size=16, seq_len=16,
                      task="mask_lm", seed=2)
    sel_frac, mask_frac = [], []
    v = tok.vocab
    for n, mds in enumerate(it):
        ids, lmask = mds.features[0], mds.labels_masks[0]
        maskable = ~np.isin(ids, [v[s] for s in (PAD, CLS, SEP)])
        sel_frac.append(lmask.sum() / maskable.sum())
        mask_frac.append(((ids == v[MASK]) & (lmask > 0)).sum()
                         / max(lmask.sum(), 1))
        if n >= 7:
            break
    assert 0.10 < np.mean(sel_frac) < 0.22, np.mean(sel_frac)
    assert 0.65 < np.mean(mask_frac) < 0.92, np.mean(mask_frac)


@pytest.mark.parametrize("seed", range(20, 30))
def test_mask_lm_random_replacement_never_special(tok, seed):
    it = BertIterator(tok, CORPUS, batch_size=4, seq_len=16,
                      task="mask_lm", seed=seed)
    v = tok.vocab
    for mds in it:
        ids, lmask = mds.features[0], mds.labels_masks[0]
        special = np.isin(ids, [v[s] for s in SPECIALS])
        assert not (special & (lmask > 0) & (ids != v[MASK])).any()


def test_trailing_partial_batch_not_dropped(tok):
    it = BertIterator(tok, CORPUS[:6], batch_size=4, seq_len=16, seed=0)
    assert [m.features[0].shape[0] for m in it] == [4, 2]
    it2 = BertIterator(tok, CORPUS[:3], batch_size=8, seq_len=16)
    assert [m.features[0].shape[0] for m in it2] == [3]


def test_reset_changes_masking(tok):
    it = BertIterator(tok, CORPUS, batch_size=4, seq_len=16, seed=3)
    a = next(iter(it)).features[0].copy()
    it.reset()
    assert (a != next(iter(it)).features[0]).any()


@pytest.mark.parametrize("pairs", (False, True))
def test_seq_classification_batches_equal_jax(tok, jtok, pairs):
    """Single sentences and pairs: tokens, segments, one-hot labels and
    pad masks equal the JAX iterator's."""
    data = ([(a, b, i % 2) for i, (a, b) in enumerate(zip(CORPUS,
                                                          CORPUS[1:]))]
            if pairs else [(t, i % 2) for i, t in enumerate(CORPUS)])
    kw = dict(batch_size=4, seq_len=16, task="seq_classification",
              num_classes=2, seed=2)
    it = BertIterator(tok, data, **kw)
    _same_batches(it, jnlp.BertIterator(jtok, data, **kw))
    mds = next(iter(it))
    assert mds.labels[0].shape == (4, 2)
    assert (mds.labels[0].sum(axis=1) == 1).all()
    fm_tok, fm_seg = mds.features_masks
    assert (fm_tok == (mds.features[0] != tok.vocab[PAD])).all()
    assert (fm_seg == fm_tok).all()
    with pytest.raises(ValueError, match="num_classes"):
        BertIterator(tok, data, task="seq_classification")
    with pytest.raises(ValueError, match="task"):
        BertIterator(tok, data, task="ner")


def test_encode_fixed_truncation_keeps_sep(tok, jtok):
    it = BertIterator(tok, CORPUS, batch_size=2, seq_len=8)
    jit = jnlp.BertIterator(jtok, CORPUS, batch_size=2, seq_len=8)
    long_text = " ".join(CORPUS)
    for args in ((long_text,), (long_text, "lazy dog"),
                 ("lazy dog", long_text)):
        assert it._encode_fixed(*args) == jit._encode_fixed(*args)
    ids, segs, n = it._encode_fixed(long_text)
    v = tok.vocab
    assert n == 8 and ids[-1] == v[SEP] and ids[0] == v[CLS]
    assert ids.count(v[SEP]) == 1 and set(segs) == {0}
    ids2, segs2, n2 = it._encode_fixed(long_text, "lazy dog")
    assert n2 == 8 and ids2.count(v[SEP]) == 2 and 1 in segs2


def test_lm_sequence_iterator_packs_like_jax(tok, jtok):
    it = LMSequenceIterator.from_texts(CORPUS, tok, batch_size=4,
                                       seq_len=12)
    jit = jnlp.LMSequenceIterator.from_texts(CORPUS, jtok, batch_size=4,
                                             seq_len=12)
    assert len(it) == len(jit)
    _same_batches(it, jit)
    ds = next(iter(it))
    x, y = ds.features, ds.labels
    np.testing.assert_array_equal(x[0, 1:], y[0, :-1])
    assert x[1, 0] == y[0, -1]


def test_lm_iterator_rejects_short_corpus():
    with pytest.raises(ValueError, match="shorter"):
        LMSequenceIterator([1, 2, 3], batch_size=2, seq_len=8)


def test_lm_iterator_trailing_windows_not_dropped():
    it = LMSequenceIterator(list(range(50)), batch_size=8, seq_len=12)
    batches = list(it)
    assert len(batches) == 1 and len(it) == 1
    assert batches[0].features.shape == (4, 12)
    it2 = LMSequenceIterator(list(range(121)), batch_size=4, seq_len=12)
    assert [b.features.shape[0] for b in it2] == [4, 4, 2]


def test_tokenizer_factory_and_preprocessor_match_jax():
    text = "Hello, World! 42 (quick) brown/fox"
    f = DefaultTokenizerFactory().set_token_pre_processor(
        CommonPreprocessor())
    jf = jnlp.DefaultTokenizerFactory().set_token_pre_processor(
        jnlp.CommonPreprocessor())
    assert f.create(text).get_tokens() == jf.create(text).get_tokens()
    assert DefaultTokenizerFactory().create(text).get_tokens() == \
        text.split()
