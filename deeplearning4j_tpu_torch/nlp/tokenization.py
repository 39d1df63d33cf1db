"""Tokenization SPI (port of ``deeplearning4j_tpu/nlp/tokenization.py``;
reference:
``org.deeplearning4j.text.tokenization.tokenizer.Tokenizer`` /
``tokenizerfactory.TokenizerFactory`` / ``DefaultTokenizer`` /
``preprocessor.CommonPreprocessor``).
"""
from __future__ import annotations

import re
from typing import Callable, List, Optional


class CommonPreprocessor:
    """Lowercase + strip punctuation/digits (reference
    CommonPreprocessor)."""

    _strip = re.compile(r"[\d.:,\"'()\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._strip.sub("", token.lower())

    __call__ = pre_process


class DefaultTokenizer:
    """Whitespace tokenizer with optional preprocessor (reference
    DefaultTokenizer over java StringTokenizer)."""

    def __init__(self, text: str, preprocessor=None):
        self._tokens = text.split()
        self._pre = preprocessor
        self._i = 0

    def set_token_pre_processor(self, pre):
        self._pre = pre

    def has_more_tokens(self) -> bool:
        return self._i < len(self._tokens)

    def next_token(self) -> str:
        t = self._tokens[self._i]
        self._i += 1
        return self._pre(t) if self._pre else t

    def get_tokens(self) -> List[str]:
        out = []
        while self.has_more_tokens():
            t = self.next_token()
            if t:
                out.append(t)
        return out


class DefaultTokenizerFactory:
    """Reference: DefaultTokenizerFactory."""

    def __init__(self):
        self._pre: Optional[Callable[[str], str]] = None

    def set_token_pre_processor(self, pre):
        self._pre = pre
        return self

    def create(self, text: str) -> DefaultTokenizer:
        return DefaultTokenizer(text, self._pre)
