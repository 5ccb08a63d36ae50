"""Scorers: BM25, TFIDF, constant boost.

Reference: core/search/bm25.{hpp,cpp}, tfidf.{hpp,cpp}, boost_scorer.hpp.
Formulas (verified against the reference implementations):

BM25 (bm25.cpp:380-408, 319-362):
    idf    = log1p((N - df + 0.5) / (df + 0.5))      [N = docs_with_field]
    weight = boost * (k + 1) * idf
    score  = weight * tf / (tf + k*(1 - b + b*dl/avgdl))   [tf = freq]
    avgdl  = total_term_freq / docs_with_field
    BM15 is b=0, BM11 is b=1, BM1 is k=0 (constant weight per match).

TFIDF (tfidf.cpp:72-75, 254-256, 276):
    idf    = log1p((N + 1) / (df + 1))
    score  = boost * idf * sqrt(freq) * (1/sqrt(dl))   [norms on]
    score  = boost * idf * sqrt(freq)                  [norms off]

Both the numpy host oracle and the device executor evaluate scores through
``score_block`` / its jnp twin so semantics cannot drift.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class Scorer:
    """Base scorer descriptor; stateless and hashable (jit cache key)."""

    def idf(self, df: int, docs_with_field: int) -> float:
        raise NotImplementedError

    @property
    def kind(self) -> str:
        raise NotImplementedError

    def term_weight(self, boost: float, idf: float) -> float:
        raise NotImplementedError

    def needs_norms(self) -> bool:
        return False


@dataclass(frozen=True)
class BM25(Scorer):
    k: float = 1.2
    b: float = 0.75

    @property
    def kind(self) -> str:
        return "bm25"

    def idf(self, df: int, docs_with_field: int) -> float:
        return math.log1p((docs_with_field - df + 0.5) / (df + 0.5))

    def term_weight(self, boost: float, idf: float) -> float:
        return boost * (self.k + 1.0) * idf

    def needs_norms(self) -> bool:
        return self.b != 0.0

    def norm_consts(self, avgdl: float) -> Tuple[float, float]:
        """(c_const, c_len): denominator = tf + c_const + c_len * dl."""
        kb = self.k * self.b
        return self.k - kb, (kb / avgdl if avgdl > 0 else kb)

    def max_score(self, weight: float, max_freq: float, min_dl: float, avgdl: float) -> float:
        """Upper bound of this term's contribution (block-max/WAND source,
        reference: wand_writer.hpp kDivNorm producers)."""
        c0, c1 = self.norm_consts(avgdl)
        tf = max_freq
        return weight * tf / (tf + c0 + c1 * min_dl)


@dataclass(frozen=True)
class TFIDF(Scorer):
    with_norms: bool = True

    @property
    def kind(self) -> str:
        return "tfidf"

    def idf(self, df: int, docs_with_field: int) -> float:
        return math.log1p((docs_with_field + 1.0) / (df + 1.0))

    def term_weight(self, boost: float, idf: float) -> float:
        return boost * idf

    def needs_norms(self) -> bool:
        return self.with_norms

    def max_score(self, weight: float, max_freq: float, min_dl: float, avgdl: float) -> float:
        tf = math.sqrt(max_freq)
        return weight * tf * (1.0 / math.sqrt(max(min_dl, 1.0)) if self.with_norms else 1.0)


@dataclass(frozen=True)
class BoostScore(Scorer):
    """Constant boost per matching doc (reference: boost_scorer.hpp)."""

    @property
    def kind(self) -> str:
        return "const"

    def idf(self, df: int, docs_with_field: int) -> float:
        return 1.0

    def term_weight(self, boost: float, idf: float) -> float:
        return boost

    def max_score(self, weight: float, max_freq: float, min_dl: float, avgdl: float) -> float:
        return weight


def score_block(
    scorer: Scorer,
    weights,  # [R] or broadcastable per-row term weight
    freqs,  # [R, B] float
    dl,  # [R, B] float doc lengths (>= 1)
    avgdl: float,
    xp=np,
):
    """Per-posting score contributions; exactly 0 where freq == 0.

    ``xp`` is numpy for the host oracle or jax.numpy on the device.
    """
    f = freqs
    if isinstance(scorer, BM25):
        # inline norm_consts: avgdl may be a traced jax scalar (callers
        # guarantee avgdl > 0, substituting 1.0 for empty fields)
        kb = scorer.k * scorer.b
        c0 = scorer.k - kb
        denom = f + (c0 + (kb / avgdl) * dl if scorer.b != 0.0 else c0)
        out = weights * f / xp.maximum(denom, 1e-9)
    elif isinstance(scorer, TFIDF):
        tf = xp.sqrt(f)
        if scorer.with_norms:
            out = weights * tf / xp.sqrt(xp.maximum(dl, 1.0))
        else:
            out = weights * tf
    elif isinstance(scorer, BoostScore):
        out = weights * (f > 0).astype(dl.dtype if hasattr(dl, "dtype") else np.float32)
    else:
        raise TypeError(f"unknown scorer {scorer!r}")
    return out


def max_score_blocks(scorer: Scorer, weight: float, max_freq, min_dl: float, avgdl: float):
    """Vectorized per-block score upper bound (WAND source; reference:
    wand_writer.hpp producers). ``max_freq`` is an array of per-block max
    frequencies; ``min_dl`` the term-level minimum doc length."""
    f = np.asarray(max_freq, np.float32)
    if isinstance(scorer, BM25):
        kb = scorer.k * scorer.b
        c0 = scorer.k - kb
        c1 = kb / avgdl if avgdl > 0 else kb
        denom = f + c0 + (c1 * min_dl if scorer.b != 0.0 else 0.0)
        return weight * f / np.maximum(denom, 1e-9)
    if isinstance(scorer, TFIDF):
        tf = np.sqrt(f)
        if scorer.with_norms:
            return weight * tf / np.sqrt(max(min_dl, 1.0))
        return weight * tf
    if isinstance(scorer, BoostScore):
        return np.where(f > 0, np.float32(weight), np.float32(0.0))
    raise TypeError(f"unknown scorer {scorer!r}")


_SCORERS = {
    "bm25": lambda a: BM25(
        k=float(a.get("k", 1.2)), b=float(a.get("b", 0.75))
    ),
    "tfidf": lambda a: TFIDF(with_norms=bool(a.get("withNorms", True))),
    "boost": lambda a: BoostScore(),
}


def get_scorer(name: str, args: dict | None = None) -> Scorer:
    """Named scorer registry (reference: scorers::get, scorers.cpp:92)."""
    if name not in _SCORERS:
        raise KeyError(f"unknown scorer: {name!r}")
    return _SCORERS[name](args or {})
