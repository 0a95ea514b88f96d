"""Device chunk-mode consensus (counterpart of
radian_tpu/ops/consensus_device.py), the ``consensus='device'`` stitch.

The reference stitches a read's window fragments with difflib's longest
matching block on the host (reference radian/sequence_assembly.py:19-48).
This formulation uses what the reference ignores: consecutive windows
are cut at a fixed signal stride, so fragment ``i`` sits near a fixed
displacement from fragment ``i-1``.  For every consecutive pair it
scores each displacement in ``[min_disp, max_disp)`` by the number of
runs of 4 matching bases, takes the best (ties to the smallest ``|d|``,
positive first), sums the displacements into positions and scatters one
vote per base into a ``[4, out_len]`` matrix, whose column argmax is the
consensus.  It is torch on the device of the fragments' tensors; its
strings are the JAX package's.  The JAX package stitches one read a
call; ``assemble_fragments_device_batch`` casts the votes of a batch's
reads in one padded call, each read with its own displacement range.

JAX quirk kept: the vote scatter (``.at[...].add(mode='drop')``) wraps
an index in ``[-out_len, 0)`` to the end of the matrix before it drops
out-of-range ones, so a base placed before column 0 votes in one of the
last columns (the JAX comment calls such votes truncated; ROADMAP Queue
3).  ``consensus_votes`` does the same.
"""

from __future__ import annotations

import numpy as np
import torch

from radian_tpu_torch.ops.consensus import _B2I, _I2B


# elements of the [reads, fragments, displacements, length] match tensor
# one call of ``consensus_votes_batch`` may hold: bounds the batch's
# memory (a few bytes an element) whatever the read lengths
MATCH_ELEMENTS = 1 << 26


def consensus_votes_batch(frags: torch.Tensor, lens: torch.Tensor, *,
                          min_disp, max_disp, out_len):
    """Vote-matrix consensus of a batch of reads' fragments, each read
    with its own displacement range and width bound.

    Args:
      frags: ``[R, F, L]`` base indices 0-3, padded with -1 (a read with
        fewer fragments is padded with empty ones at the end).
      lens: ``[R, F]`` fragment lengths; zero-length fragments cast no
        vote.
      min_disp, max_disp: ``[R]`` host integers, the displacement range
        ``[min_disp, max_disp)`` searched per pair; a negative
        ``min_disp`` lets a fragment start before its predecessor, as
        difflib's can (reference sequence_assembly.py:30-33).
      out_len: ``[R]`` host integers, each read's consensus width bound.

    Returns:
      ``(votes [R, 4, max(out_len)] f32, total [R])``; read ``r``'s votes
      are ``votes[r, :, :out_len[r]]``.
    """
    dev = frags.device
    r, f, l = frags.shape
    lo = np.asarray(min_disp, np.int64)
    hi = np.asarray(max_disp, np.int64)
    width = int(np.max(out_len))
    lens = lens.to(device=dev, dtype=torch.int64)
    pos = torch.arange(l, device=dev)
    disps = torch.arange(int(lo.min()), int(hi.max()), device=dev)
    # cur[j] against prev[d + j] (fragment 0 against itself), for every
    # pair and displacement
    prev = torch.cat([frags[:, :1], frags[:, :-1]], 1)
    prev_len = torch.cat([lens[:, :1], lens[:, :-1]], 1)
    idx = disps[:, None] + pos[None, :]  # [D, L]
    prev_at = prev[:, :, torch.clamp(idx, 0, l - 1)]  # [R, F, D, L]
    ok = ((idx >= 0) & (idx[None, None] < prev_len[..., None, None])
          & (pos < lens[..., None, None]))
    m = ok & (prev_at == frags[:, :, None, :])
    run4 = m[..., :-3] & m[..., 1:-2] & m[..., 2:-1] & m[..., 3:]
    scores = run4.sum(-1)  # [R, F, D]
    # composite key: the run count, then -2|d| + (d >= 0); any span wider
    # than the preference's range orders the pairs the same, so one span
    # serves every read
    pref = -2 * disps.abs() + (disps >= 0).long()
    span = 2 * (int(hi.max()) - int(lo.min())) + 2
    key = scores * span + pref
    in_range = ((disps >= torch.from_numpy(lo).to(dev)[:, None])
                & (disps < torch.from_numpy(hi).to(dev)[:, None]))
    key = key.masked_fill(~in_range[:, None, :], torch.iinfo(torch.int64).min)
    disp = disps[torch.argmax(key, dim=2)]  # [R, F]
    disp[:, 0] = 0
    positions = torch.cumsum(disp, 1)

    flat_pos = positions[..., None] + pos  # [R, F, L]
    base = frags.long()
    valid = (pos < lens[..., None]) & (base >= 0)
    # JAX's scatter: an index in [-out_len, 0) wraps, others outside
    # [0, out_len) drop (each into a spare slot of its own past the
    # matrix, so that the dropped votes do not contend for one address)
    out_r = torch.from_numpy(np.asarray(out_len, np.int64)).to(dev)
    out_r = out_r[:, None, None]
    flat_pos = torch.where(flat_pos < 0, flat_pos + out_r, flat_pos)
    keep = valid & (flat_pos >= 0) & (flat_pos < out_r)
    row = torch.arange(r, device=dev)[:, None, None]
    index = (row * 4 + torch.clamp(base, 0, 3)) * width + flat_pos
    spare = r * 4 * width + torch.arange(r * f * l, device=dev)
    index = torch.where(keep, index, spare.view(r, f, l))
    votes = torch.zeros(r * 4 * width + r * f * l, dtype=torch.float32,
                        device=dev)
    votes.index_put_((index.reshape(-1),),
                     torch.ones((), dtype=torch.float32, device=dev),
                     accumulate=True)
    total = torch.where(lens > 0, positions + lens, 0).max(1).values
    total = torch.minimum(torch.clamp(total, min=0), out_r[:, 0, 0])
    return votes[:r * 4 * width].view(r, 4, width), total


def consensus_votes(frags: torch.Tensor, lens: torch.Tensor, *,
                    max_disp: int, out_len: int, min_disp: int = 0):
    """One read's vote matrix (``consensus_votes_batch`` with one read).

    Args:
      frags: ``[F, L]`` base indices 0-3, padded with -1.
      lens: ``[F]`` fragment lengths.
      max_disp, min_disp: the displacement range ``[min_disp, max_disp)``.
      out_len: consensus width bound.

    Returns:
      ``(votes [4, out_len] f32, total_len)``, ``total_len`` a 0-d
      tensor.
    """
    votes, total = consensus_votes_batch(
        frags[None], lens[None], min_disp=[min_disp], max_disp=[max_disp],
        out_len=[out_len])
    return votes[0], total[0]


def assemble_fragments_device(fragments: list[str], max_disp: int = 256,
                              neg_disp: int | None = None,
                              device: str | torch.device = "cuda") -> str:
    """Fragments (decoder order) → consensus string, the votes cast on
    ``device`` (``assemble_fragments_device_batch`` with one read)."""
    return assemble_fragments_device_batch(
        [fragments], max_disp=max_disp, neg_disp=neg_disp,
        device=device)[0]


def assemble_fragments_device_batch(reads: list[list[str]],
                                    max_disp: int = 256,
                                    neg_disp: int | None = None,
                                    device: str | torch.device = "cuda"
                                    ) -> list[str]:
    """Each read's fragments (decoder order) → its consensus string, the
    votes of many reads cast in one padded call on ``device``.

    A read's displacement range and width bound are those of the JAX
    package's one-read ``assemble_fragments_device``: ``[lo, hi)`` with
    ``hi = min(max_disp, l + 1)`` and ``lo`` down to ``neg_disp`` (a
    quarter of the search window by default, at least 8), ``l`` the
    read's longest fragment.  Reads are grouped in order so that a
    call's match tensor stays within ``MATCH_ELEMENTS``.  The column
    argmax is taken on the host copy, first maximum on ties.
    """
    out = [""] * len(reads)
    prep = []
    for k, fragments in enumerate(reads):
        if not fragments:
            continue
        codes = [_B2I[np.frombuffer(s.encode(), np.uint8)] for s in fragments]
        if any(c.size and c.max() > 3 for c in codes):
            raise ValueError("fragments must hold only the bases ACGT")
        l = max(max(len(c) for c in codes), 1)
        hi = min(max_disp, l + 1)
        lo = -min(neg_disp if neg_disp is not None else max(hi // 4, 8), l)
        prep.append((k, codes, l, lo, hi, len(codes) * l + 1))

    def flush(group):
        f = max(len(g[1]) for g in group)
        l = max(g[2] for g in group)
        arr = np.full((len(group), f, l), -1, np.int8)
        lens = np.zeros((len(group), f), np.int32)
        for i, (_, codes, *_rest) in enumerate(group):
            for j, c in enumerate(codes):
                arr[i, j, :len(c)] = c
                lens[i, j] = len(c)
        votes, total = consensus_votes_batch(
            torch.from_numpy(arr).to(device),
            torch.from_numpy(lens).to(device),
            min_disp=[g[3] for g in group], max_disp=[g[4] for g in group],
            out_len=[g[5] for g in group])
        total = total.cpu().numpy()
        votes = votes[:, :, :max(int(total.max()), 1)].cpu().numpy()
        for i, g in enumerate(group):
            v = votes[i, :, :int(total[i])]
            if v.shape[1]:
                out[g[0]] = _I2B[np.argmax(v, axis=0)].tobytes().decode()

    group, dims = [], (0, 0, 0, 0)
    for g in prep:
        grown = (max(dims[0], len(g[1])), max(dims[1], g[2]),
                 min(dims[2], g[3]), max(dims[3], g[4]))
        size = (len(group) + 1) * grown[0] * grown[1] * (grown[3] - grown[2])
        if group and size > MATCH_ELEMENTS:
            flush(group)
            group, grown = [], (len(g[1]), g[2], g[3], g[4])
        group.append(g)
        dims = grown
    if group:
        flush(group)
    return out
