"""Query layer (reference: core/search/).

``filters`` is the user-facing AST; ``prepare()`` compiles a filter against
an index snapshot (collecting index-wide stats like the reference's
filter::prepare), and execution is either the numpy host oracle
(``host_eval``) or the device executor (``executor``) — both share the same
term-expansion planner and produce identical results.
"""

from iresearch_tpu.search.filters import (
    All,
    And,
    ByColumnExistence,
    ByEditDistance,
    ByNested,
    ByPhrase,
    ByPrefix,
    ByRange,
    BySamePosition,
    ByTerm,
    ByTerms,
    ByWildcard,
    Empty,
    Not,
    Or,
)
from iresearch_tpu.search.scorers import BM25, TFIDF, BoostScore, get_scorer

__all__ = [
    "All",
    "And",
    "ByColumnExistence",
    "ByEditDistance",
    "ByNested",
    "ByPhrase",
    "ByPrefix",
    "ByRange",
    "BySamePosition",
    "ByTerm",
    "ByTerms",
    "ByWildcard",
    "Empty",
    "Not",
    "Or",
    "BM25",
    "TFIDF",
    "BoostScore",
    "get_scorer",
]
