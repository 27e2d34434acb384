"""Sort-key packing — port of ``spark_rapids_tpu/ops/sortkeys.py``.

Typed columns become int64 key words whose lexicographic signed order is
the requested SQL order; sort, sort-based group-by and the join's sorted
build side all order rows through them:

* integers, dates and decimals up to 18 digits are their own key; a
  descending key is the bitwise NOT of the ascending one;
* floats use the IEEE total-order trick with Spark's normalisation: -0.0
  keys with 0.0 and every NaN collapses to one key that sorts largest;
* decimal128 takes two words, ``hi`` and ``lo`` rebased to signed order;
* a string of width w takes ceil(w / 8) words, 8 bytes each big-endian
  with the top bit flipped (the reference's words), then its length as a
  last word.  The reference carries no length, so "a" and "a\x00" get
  equal words there and group and join as one key; with the length they
  stay apart and "a" sorts first, as in Spark.  Two string columns whose
  words are compared must first meet at one width (``with_width``);
* nulls are a leading word per column (-1 null / 0 valid for NULLS FIRST,
  1 / 0 for NULLS LAST), never flipped by the direction.

``jax.lax.sort`` sorts a tuple of key words in one call; ``torch.sort``
takes one key, so ``lexsort`` makes one stable pass per word, from the last
word to the first.  That is exact for any number of words: no two words are
ever packed into one.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn

_INT64_MAX = 0x7FFFFFFFFFFFFFFF
_CANONICAL_NAN = 0x7FF8000000000000


@dataclasses.dataclass(frozen=True)
class SortSpec:
    """One ORDER BY term: direction and null ordering (Spark's SortOrder)."""

    ascending: bool = True
    nulls_first: bool = True


def _float_total_order(bits: torch.Tensor) -> torch.Tensor:
    """IEEE bits (int64) -> monotone signed key: negative floats flip their
    value bits so they order reversed below +0.0; NaN lands above +inf."""
    return torch.where(bits < 0, bits ^ _INT64_MAX, bits)


def float_order_key(vals: torch.Tensor) -> torch.Tensor:
    """float tensor -> monotone int64 key: -0.0 keys with 0.0, every NaN
    bit pattern keys as the canonical NaN, which sorts greatest."""
    d = vals.to(torch.float64)
    d = torch.where(d == 0.0, torch.zeros_like(d), d)
    bits = d.view(torch.int64)
    bits = torch.where(torch.isnan(d),
                       torch.full_like(bits, _CANONICAL_NAN), bits)
    return _float_total_order(bits)


def _column_key_words(c: DeviceColumn) -> List[torch.Tensor]:
    """int64 key words of one column for ASC order (nulls handled apart)."""
    dt = c.dtype
    if c.is_string:
        return string_key_words(c.chars) + [c.lengths.to(torch.int64)]
    if isinstance(dt, (T.FloatType, T.DoubleType)):
        return [float_order_key(c.data)]
    if isinstance(dt, T.DecimalType) and dt.is_128:
        from spark_rapids_tpu_torch.expr.decimal128 import key_words, unpack

        return list(key_words(*unpack(c.data)))
    return [c.data.to(torch.int64)]


def string_key_words(chars: torch.Tensor) -> List[torch.Tensor]:
    """A (rows, width) uint8 char matrix -> ceil(width / 8) int64 words in
    byte order: 8 bytes a word, big-endian, zero past the width, the top
    bit flipped so signed order is unsigned byte order.  The bytes widen
    to int64 before they shift (a shift of a uint8 wraps in its byte)."""
    n, w = chars.shape
    nwords = (w + 7) // 8
    if nwords * 8 != w:
        chars = torch.nn.functional.pad(chars, (0, nwords * 8 - w))
    b = chars.reshape(n, nwords, 8).to(torch.int64)
    shifts = torch.arange(56, -1, -8, dtype=torch.int64, device=chars.device)
    words = (b << shifts).sum(dim=2) ^ torch.iinfo(torch.int64).min
    return list(words.T.contiguous())


def pack_sort_keys(cols: Sequence[DeviceColumn], specs: Sequence[SortSpec],
                   row_mask: torch.Tensor) -> List[torch.Tensor]:
    """The key words for ``lexsort``, first to last.  Rows outside
    ``row_mask`` take the largest key in every word and sort last."""
    keys: List[torch.Tensor] = []
    pad = torch.tensor(_INT64_MAX, dtype=torch.int64, device=row_mask.device)
    for c, spec in zip(cols, specs):
        null_key = torch.where(c.validity, 0, -1 if spec.nulls_first else 1)
        keys.append(torch.where(row_mask, null_key.to(torch.int64), pad))
        for w in _column_key_words(c):
            k = w if spec.ascending else ~w
            # null rows take a neutral word: the null group stays together
            k = torch.where(c.validity, k, 0)
            keys.append(torch.where(row_mask, k, pad))
    return keys


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation ordering rows by ``keys`` lexicographically, the
    first key most significant: one stable ``torch.sort`` per key, from the
    last key to the first."""
    perm = None
    for k in reversed(keys):
        if perm is None:
            perm = torch.sort(k, stable=True).indices
        else:
            perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def word_ranks(words: Sequence[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's dense rank among the rows' key ``words`` (equal words
    share a rank; ranks in the words' order), and for each rank the index
    of a row that holds it: one stable ``lexsort``."""
    n = words[0].shape[0]
    order = lexsort(words)
    change = torch.zeros(n, dtype=torch.bool, device=order.device)
    change[:1] = True
    for w in words:
        ws = w[order]
        change[1:] |= ws[1:] != ws[:-1]
    rank_sorted = torch.cumsum(change.to(torch.int64), 0) - 1
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    holder = torch.zeros(n, dtype=torch.int64, device=order.device).scatter_(
        0, rank_sorted[change], order[change])
    return rank, holder


def sort_permutation(cols: Sequence[DeviceColumn],
                     specs: Sequence[SortSpec],
                     row_mask: torch.Tensor) -> torch.Tensor:
    """The row permutation realising the ordering (stable)."""
    return lexsort(pack_sort_keys(cols, specs, row_mask))


def group_segments(sorted_key_words: Sequence[torch.Tensor],
                   row_mask_sorted: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Key words already in sorted row order -> (segment ids, group count),
    where equal consecutive keys share a segment id.  Rows outside the mask
    (sorted to the tail) are not counted as groups.  The count stays on the
    device."""
    n = row_mask_sorted.shape[0]
    dev = row_mask_sorted.device
    if n == 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    change = torch.zeros(n, dtype=torch.bool, device=dev)
    for k in sorted_key_words:
        change[1:] |= k[1:] != k[:-1]
    change[0] = True
    seg = torch.cumsum(change.to(torch.int64), 0) - 1
    n_valid = row_mask_sorted.sum()
    last = seg[(n_valid - 1).clamp(min=0)]
    return seg, torch.where(n_valid > 0, last + 1, 0)
