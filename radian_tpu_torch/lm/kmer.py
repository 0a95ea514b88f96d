"""12-mer mRNA language model tables (counterpart of radian_tpu/lm/kmer.py).

The reference ships the LM as a JSON dict mapping an 11-base context
string to a 4-probability next-base distribution (reference
radian/basecall.py:48-57), consulted per beam extension with a
per-context entropy cache (reference radian/decode.py:79-96).

For the decoder it becomes two dense device arrays indexed by the
base-4-packed context:

- ``probs``   ``[4^context_len, 4]`` float32 next-base distributions
- ``entropy`` ``[4^context_len]``   float32 distribution entropies (the
  whole table precomputed replaces the reference's lazily filled cache)

Contexts absent from a sparse JSON are filled with the uniform
distribution, whose entropy ``log 4 ≈ 1.386`` exceeds any sensible
``r_threshold`` (default 0.5), so the fusion gate rejects them: the
signal model runs un-fused, as if the context were unknown.

numpy only; same functions, same arrays bit for bit, and the same random
draws as the JAX package's module.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

N_BASES = 4
BASES = "ACGT"
_BASE_INDEX = {b: i for i, b in enumerate(BASES)}


def pack_context(context) -> int:
    """Pack a base-index tuple (or 'ACGT' string) big-endian in base 4."""
    v = 0
    for b in context:
        v = v * N_BASES + (_BASE_INDEX[b] if isinstance(b, str) else int(b))
    return v


@dataclasses.dataclass
class KmerLM:
    context_len: int
    probs: np.ndarray  # [4^context_len, 4] float32
    entropy: np.ndarray  # [4^context_len] float32
    # bool per context: True where the source model defined a real
    # distribution, False where densification filled in the uniform row;
    # None when provenance is unknown (hand-built tables): compression
    # then falls back to exact row deduplication
    real_mask: np.ndarray | None = None

    @property
    def n_contexts(self) -> int:
        return self.probs.shape[0]

    def compressed(self):
        """Exact two-level packing of the dense tables.

        Returns ``(l1 int32 [ceil(R/32), 2], vals float32 [U+1, 5])``:

        - ``l1[b, 0]``: presence bitmap word for contexts ``32b..32b+31``
          (bit ``i`` set iff context ``32b+i`` has a real row)
        - ``l1[b, 1]``: rank, the number of real contexts before ``32b``
        - ``vals[0]``: the shared default (uniform) row; ``vals[1+k]``:
          the k-th real context's ``[p_A..p_T, entropy]`` row, in context
          order

        Lookup: ``word, rank = l1[ctx >> 5]``; ``present = word >> (ctx &
        31) & 1``; ``idx = present ? 1 + rank + popcount(word & ((1 <<
        bitpos) - 1)) : 0``.  Values are bit-identical to the dense rows.
        """
        r = self.n_contexts
        table = np.concatenate(
            [self.probs, self.entropy[:, None]], axis=1
        ).astype(np.float32)  # [R, 5]
        if self.real_mask is not None:
            mask = self.real_mask.astype(bool)
        else:
            # unknown provenance: the most common row is the default and
            # everything else "real", which is exact either way
            rows, inverse, counts = np.unique(
                table, axis=0, return_inverse=True, return_counts=True
            )
            default = int(np.argmax(counts))
            mask = inverse != default
        pad = (-r) % 32
        bits = np.pad(mask, (0, pad)).reshape(-1, 32)
        words = (bits.astype(np.uint32) << np.arange(32, dtype=np.uint32)
                 ).sum(axis=1, dtype=np.uint32)
        rank = np.zeros(len(words), np.uint32)
        rank[1:] = np.cumsum(bits.sum(axis=1, dtype=np.uint32))[:-1]
        l1 = np.stack([words, rank], axis=1).view(np.int32)
        if mask.any():
            real_rows = table[mask]
            # the default row: any non-real row (all identical); if every
            # context is real there is no default and row 0 is unused
            nonreal = np.flatnonzero(~mask)
            default_row = (
                table[nonreal[0]] if len(nonreal) else np.zeros(5, np.float32)
            )
        else:
            real_rows = np.zeros((0, 5), np.float32)
            default_row = table[0]
        vals = np.concatenate([default_row[None], real_rows], axis=0)
        return l1, vals


def _entropy_rows(probs: np.ndarray) -> np.ndarray:
    """Row entropies, zero-probability events contributing nothing
    (reference decode.py:73-76); computed in the input's dtype (float64
    from :func:`build_dense_tables`), returned as float32."""
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(probs > 0, probs * np.log(probs), 0.0)
    return (-terms.sum(axis=-1)).astype(np.float32)


def build_dense_tables(model: dict, context_len: int = 11) -> KmerLM:
    """Densify ``{context tuple/str: [p_A,p_C,p_G,p_T]}`` into tables."""
    n = N_BASES**context_len
    probs = np.full((n, N_BASES), 1.0 / N_BASES, dtype=np.float32)
    real_mask = np.zeros(n, bool)
    for ctx, dist in model.items():
        if len(ctx) != context_len:
            raise ValueError(
                f"context {ctx!r} has length {len(ctx)}, expected {context_len}"
            )
        v = pack_context(ctx)
        probs[v] = np.asarray(dist, dtype=np.float32)
        real_mask[v] = True
    return KmerLM(context_len, probs, _entropy_rows(probs.astype(np.float64)),
                  real_mask)


def load_kmer_json(path: str | Path, context_len: int = 11) -> KmerLM:
    """Load the reference's JSON format (string contexts) into dense tables."""
    with open(path) as f:
        raw = json.load(f)
    model = {
        tuple(_BASE_INDEX[b] for b in ctx): dist for ctx, dist in raw.items()
    }
    return build_dense_tables(model, context_len)


def random_kmer_model(
    rng: np.random.Generator,
    context_len: int = 5,
    n_contexts: int | None = None,
    concentration: float = 0.3,
) -> dict:
    """Synthesize a sparse k-mer model dict (for tests and benchmarks).

    Low ``concentration`` yields peaked distributions (low entropy), so
    the fusion gate fires.  Draws from ``rng`` in the JAX package's
    order: the same generator state gives the same dict.
    """
    total = N_BASES**context_len
    if n_contexts is None or n_contexts >= total:
        idx = np.arange(total)
    else:
        idx = rng.choice(total, size=n_contexts, replace=False)
    model = {}
    for v in idx:
        ctx = tuple((v // N_BASES**p) % N_BASES
                    for p in range(context_len - 1, -1, -1))
        model[ctx] = rng.dirichlet(np.full(N_BASES, concentration)).tolist()
    return model
