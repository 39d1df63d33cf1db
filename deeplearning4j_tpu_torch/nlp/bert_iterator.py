"""BERT-style data pipelines (port of
``deeplearning4j_tpu/nlp/bert_iterator.py``, numpy only, kept as the
port's own copy: the same vocabularies, token ids, 80/10/10 masking
from the same ``seed`` and the same batches).

Reference: ``org.deeplearning4j.iterator.BertIterator`` (tasks
UNSUPERVISED/masked-LM and SEQ_CLASSIFICATION, fixed-length truncate/
pad, masked-token 80/10/10 corruption) and
``o.d.text.tokenization.tokenizer.BertWordPieceTokenizer`` (greedy
longest-match wordpiece over a fixed vocab with ``##`` continuations).
Plus ``LMSequenceIterator`` — the causal-LM analog of the reference's
char-RNN ``CharacterIterator``: pack a token stream into [B, T]
next-token batches for ``zoo.CausalTransformerLM``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = (PAD, UNK, CLS, SEP, MASK)


class BertWordPieceTokenizer:
    """Greedy longest-match wordpiece (reference
    BertWordPieceTokenizer): lowercases, splits on whitespace, then
    decomposes each word into the longest vocab prefixes with ``##``
    continuation pieces; words with no valid decomposition → [UNK]."""

    def __init__(self, vocab: Dict[str, int], lower_case: bool = True,
                 max_word_chars: int = 100):
        self.vocab = vocab
        self.lower_case = lower_case
        self.max_word_chars = max_word_chars

    @classmethod
    def from_vocab_file(cls, path, **kw) -> "BertWordPieceTokenizer":
        """Load a standard BERT ``vocab.txt`` (one piece per line, id =
        line number) — the reference's
        ``BertWordPieceTokenizer(vocabFile)`` entry point."""
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                piece = line.rstrip("\r\n")      # CRLF-safe
                if piece in vocab:
                    raise ValueError(
                        f"duplicate piece {piece!r} at line {i} of "
                        f"{path} — ids would shift silently")
                vocab[piece] = i
        return cls(vocab, **kw)

    def save_vocab(self, path) -> None:
        """Write ``vocab.txt`` (inverse of :meth:`from_vocab_file`).
        Requires contiguous ids 0..V-1 — the line-number format cannot
        represent gaps, which would silently remap ids on reload."""
        ids = sorted(self.vocab.values())
        if ids != list(range(len(ids))):
            raise ValueError(
                "vocab ids are not contiguous 0..V-1; saving to the "
                "line-number vocab.txt format would remap them")
        inv = sorted(self.vocab.items(), key=lambda kv: kv[1])
        with open(path, "w", encoding="utf-8") as f:
            for piece, _ in inv:
                f.write(piece + "\n")

    @classmethod
    def build_vocab(cls, sentences: Iterable[str],
                    max_pieces: int = 30000) -> Dict[str, int]:
        """Tiny wordpiece-vocab builder for tests/toy corpora: all
        specials, then whole words, then all character pieces (with
        ``##`` variants) so every word is decomposable."""
        from collections import Counter
        words = Counter()
        chars = set()
        for s in sentences:
            for w in s.lower().split():
                words[w] += 1
                chars.update(w)
        vocab: Dict[str, int] = {t: i for i, t in enumerate(SPECIALS)}
        for ch in sorted(chars):
            for piece in (ch, "##" + ch):
                if piece not in vocab:
                    vocab[piece] = len(vocab)
        for w, _ in words.most_common():
            if len(vocab) >= max_pieces:
                break
            if w not in vocab:
                vocab[w] = len(vocab)
        return vocab

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in (text.lower() if self.lower_case
                     else text).split():
            if len(word) > self.max_word_chars:
                out.append(UNK)
                continue
            pieces, start = [], 0
            while start < len(word):
                end, cur = len(word), None
                while start < end:
                    sub = word[start:end]
                    if start > 0:
                        sub = "##" + sub
                    if sub in self.vocab:
                        cur = sub
                        break
                    end -= 1
                if cur is None:
                    pieces, start = [UNK], len(word)
                    break
                pieces.append(cur)
                start = end
            out.extend(pieces)
        return out

    def encode(self, text: str) -> List[int]:
        return [self.vocab[t] for t in self.tokenize(text)]


class BertIterator:
    """Reference ``BertIterator``: sentence (or pair) provider →
    fixed-length [B, T] token-id batches.

    ``task="mask_lm"``: 15% of non-special positions are selected; of
    those 80% → [MASK], 10% → random token, 10% kept — labels carry
    the ORIGINAL ids at selected positions and ``labels_mask`` scores
    only them (reference UNSUPERVISED task semantics).
    ``task="seq_classification"``: labels from the provider.

    Yields ``MultiDataSet([tokens, segments], ...)`` matching
    ``zoo.Bert``'s (tokens, segments) inputs; the trailing batch may be
    smaller than ``batch_size`` (nothing is dropped).
    ``one_hot_labels=True`` (default, reference format) emits [B, T, V]
    one-hot MLM labels for ``conf_mlm``'s softmax CE; ``False`` emits
    sparse [B, T] int ids for sparse-CE heads.
    """

    def __init__(self, tokenizer: BertWordPieceTokenizer,
                 sentences: Sequence, batch_size: int = 8,
                 seq_len: int = 64, task: str = "mask_lm",
                 mask_prob: float = 0.15, one_hot_labels: bool = True,
                 num_classes: Optional[int] = None, seed: int = 0):
        if task not in ("mask_lm", "seq_classification"):
            raise ValueError(f"unknown BertIterator task {task!r}")
        if task == "seq_classification" and num_classes is None:
            raise ValueError("seq_classification needs num_classes")
        self.tok = tokenizer
        self.sentences = list(sentences)
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.task = task
        self.mask_prob = mask_prob
        self.one_hot = one_hot_labels
        self.num_classes = num_classes
        self.seed = seed
        self._epoch = 0

    def reset(self):
        self._epoch += 1          # fresh masking every epoch

    def _encode_fixed(self, text, text_b=None):
        """[CLS] a [SEP] (b [SEP]) truncated/padded to seq_len; returns
        (ids, segments, valid_len). Truncation is PAIR-AWARE
        (reference ``truncateSeqPair``): tokens pop off the longer
        sentence first, so both segments — and both [SEP] markers —
        always survive."""
        v = self.tok.vocab
        a = self.tok.encode(text)
        if text_b is None:
            a = a[:self.seq_len - 2]
            ids = [v[CLS]] + a + [v[SEP]]
            segs = [0] * len(ids)
        else:
            b = self.tok.encode(text_b)
            budget = self.seq_len - 3          # [CLS] + 2×[SEP]
            while len(a) + len(b) > budget:
                (a if len(a) >= len(b) else b).pop()
            ids = [v[CLS]] + a + [v[SEP]] + b + [v[SEP]]
            segs = [0] * (len(a) + 2) + [1] * (len(b) + 1)
        n = len(ids)
        ids += [v[PAD]] * (self.seq_len - n)
        segs += [0] * (self.seq_len - n)
        return ids, segs, n

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self._epoch)
        v = self.tok.vocab
        special_ids = {v[t] for t in SPECIALS}
        n_vocab = len(v)
        # non-special id pool by VALUE, not by position: external
        # vocabs (e.g. real BERT vocab.txt) scatter specials anywhere
        nonspecial = np.setdiff1d(np.arange(n_vocab),
                                  np.asarray(sorted(special_ids)))
        for i in range(0, len(self.sentences), self.batch_size):
            batch = self.sentences[i:i + self.batch_size]
            bs = len(batch)            # trailing batch may be short
            ids = np.zeros((bs, self.seq_len), np.int32)
            segs = np.zeros((bs, self.seq_len), np.int32)
            labels_cls = np.zeros((bs,), np.int64)
            for j, item in enumerate(batch):
                if self.task == "seq_classification":
                    if isinstance(item, (tuple, list)) and len(item) == 3:
                        text, text_b, label = item
                    else:
                        (text, label), text_b = item, None
                    labels_cls[j] = int(label)
                else:
                    if isinstance(item, (tuple, list)):
                        text = item[0]
                        text_b = item[1] if len(item) > 1 else None
                    else:
                        text, text_b = item, None
                ids[j], segs[j], _ = self._encode_fixed(text, text_b)
            # [PAD] keys must not be attended (upstream BertIterator
            # emits an input mask alongside tokens/segments); one mask
            # per graph input, threaded to attention as the key mask
            pad_mask = (ids != v[PAD]).astype(np.float32)
            if self.task == "seq_classification":
                y = np.eye(self.num_classes,
                           dtype=np.float32)[labels_cls]
                yield MultiDataSet([ids, segs], [y],
                                   features_masks=[pad_mask, pad_mask])
                continue
            # masked LM: select, corrupt 80/10/10, score selected only
            selectable = ~np.isin(ids, list(special_ids))
            sel = selectable & (rng.random(ids.shape) < self.mask_prob)
            # guarantee ≥1 selected position per example
            for j in range(bs):
                if selectable[j].any() and not sel[j].any():
                    sel[j, rng.choice(np.flatnonzero(selectable[j]))] \
                        = True
            corrupted = ids.copy()
            r = rng.random(ids.shape)
            corrupted[sel & (r < 0.8)] = v[MASK]
            rnd = sel & (r >= 0.8) & (r < 0.9)
            # random replacements draw from NON-special ids only
            corrupted[rnd] = rng.choice(nonspecial, int(rnd.sum()))
            lmask = sel.astype(np.float32)
            if self.one_hot:
                # scatter, not np.eye-index: eye would allocate an
                # O(V²) identity per batch (3.6 GB at V=30k)
                y = np.zeros((bs, self.seq_len, n_vocab), np.float32)
                bi, ti = np.indices(ids.shape)
                y[bi, ti, ids] = 1.0
            else:
                y = ids.astype(np.int32)
            yield MultiDataSet([corrupted, segs], [y],
                               features_masks=[pad_mask, pad_mask],
                               labels_masks=[lmask])


class LMSequenceIterator:
    """Causal-LM packing (the transformer-era ``CharacterIterator``):
    concatenate the encoded corpus into one token stream and cut it
    into [B, T] (inputs, next-token targets) DataSets for
    ``zoo.CausalTransformerLM`` (sparse int targets). The trailing
    batch may be short — every packable window is yielded."""

    def __init__(self, token_stream: Sequence[int], batch_size: int,
                 seq_len: int):
        self.tokens = np.asarray(token_stream, np.int32)
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.n_windows = (self.tokens.size - 1) // seq_len
        if self.n_windows < 1:
            raise ValueError(f"corpus of {self.tokens.size} tokens is "
                             f"shorter than seq_len+1={seq_len + 1}")
        # trailing short batch included — no window is dropped
        self.n_batches = -(-self.n_windows // batch_size)

    @classmethod
    def from_texts(cls, texts: Iterable[str],
                   tokenizer: BertWordPieceTokenizer, batch_size: int,
                   seq_len: int) -> "LMSequenceIterator":
        stream: List[int] = []
        sep = tokenizer.vocab[SEP]
        for t in texts:
            stream.extend(tokenizer.encode(t))
            stream.append(sep)
        return cls(stream, batch_size, seq_len)

    def reset(self):
        pass

    def __len__(self):
        return self.n_batches

    def __iter__(self):
        T, B = self.seq_len, self.batch_size
        for b in range(self.n_batches):
            rows = min(B, self.n_windows - b * B)
            xs = np.zeros((rows, T), np.int32)
            ys = np.zeros((rows, T), np.int32)
            for j in range(rows):
                o = (b * B + j) * T
                xs[j] = self.tokens[o:o + T]
                ys[j] = self.tokens[o + 1:o + T + 1]
            yield DataSet(xs, ys)
