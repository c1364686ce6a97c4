"""The summation order of ``csrc/emb_grad.cu`` in numpy, shared by the CPU
tests (against the JAX package) and the card tests (against the kernel's
bits).

The same stable sort of the ids (outside [0, V) as V), the same pieces of
``PIECE`` sorted entries, groups of ``GROUP`` pieces and row sums, each a
compensated fp32 sum (Kahan, handing on acc - c) in the kernel's order,
so on bf16-representable cotangents it gives the kernel's bits.  It also
asserts what the kernel relies on: each row of the result is written once
and no sum reads a partial row that nothing wrote."""

import numpy as np

from datamining_recblr_torch.ops import embedding as E

P, G = E.PIECE, E.GROUP


def _kahan(rows):
    """The compensated fp32 sum of ``rows`` [k, D] in order, as acc - c."""
    acc = np.zeros(rows.shape[1], np.float32)
    c = np.zeros_like(acc)
    for r in rows:
        y = r - c
        t = acc + y
        c = (t - acc) - y
        acc = t
    return acc - c


def _first_piece_at_least(keys, lo, hi, v):
    while lo < hi:
        mid = (lo + hi) // 2
        if keys[mid * P] < v:
            lo = mid + 1
        else:
            hi = mid
    return lo


def schedule_sum(ids, g, v):
    """[V, D] fp32 table gradient of ``ids`` [N] and ``g`` [N, D] summed
    as the kernel sums it."""
    ids = np.asarray(ids).reshape(-1).astype(np.int64)
    g = np.asarray(g, np.float32).reshape(ids.size, -1)
    d = g.shape[1]
    key = np.where((ids < 0) | (ids >= v), v, ids)
    order = np.argsort(key, kind="stable")
    keys = key[order]
    m = int((key < v).sum())
    npieces = -(-m // P)
    nan = np.full((max(npieces, 1), d), np.nan, np.float32)
    out = np.full((v, d), np.nan, np.float32)
    first, last = nan.copy(), nan.copy()

    # pieces: runs in order; a run inside the piece goes to out, a first
    # run continuing the previous piece's segment to first, a last run
    # starting a segment that goes on to last
    for p in range(npieces):
        k0 = p * P
        n = min(P, m - k0)
        prev = keys[k0 - 1] if k0 > 0 else -2
        nxt = keys[k0 + n] if k0 + n < m else -2
        bounds = [k0] + [k0 + i for i in range(1, n) if keys[k0 + i] != keys[k0 + i - 1]]
        bounds.append(k0 + n)
        for r, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
            cur = keys[a]
            before = r == 0 and prev == cur
            after = b == k0 + n and nxt == cur and not before
            value = _kahan(g[order[a:b]])
            if before:
                first[p] = value
            elif after:
                last[p] = value
            else:
                assert np.isnan(out[cur]).all(), f"row {cur} written twice"
                out[cur] = value

    # groups: the prefix continuing the segment that enters the group, the
    # suffix continuing the segment of its last piece's first entry
    ngroups = -(-npieces // G)
    gpre = np.full((max(ngroups, 1), d), np.nan, np.float32)
    gsuf = gpre.copy()
    for j in range(ngroups):
        q_lo, q_hi = j * G, min(npieces, j * G + G) - 1
        pre_end = q_lo
        if q_lo > 0 and keys[q_lo * P - 1] == keys[q_lo * P]:
            pre_end = _first_piece_at_least(keys, q_lo, q_hi + 1, keys[q_lo * P] + 1)
        w = keys[q_hi * P]
        suf = _first_piece_at_least(keys, q_lo, q_hi, w)
        if suf == 0 or keys[suf * P - 1] != w:
            suf += 1
        if pre_end > q_lo:
            gpre[j] = _kahan(first[q_lo:pre_end])
            if suf == q_lo:
                gsuf[j] = gpre[j]
                continue
        if suf <= q_hi:
            gsuf[j] = _kahan(first[suf:q_hi + 1])

    # rows: zeros, or a segment over several pieces from its partials
    seg = np.searchsorted(keys[:m], np.arange(v + 1), side="left")
    for vv in range(v):
        s, e = int(seg[vv]), int(seg[vv + 1])
        if s == e:
            assert np.isnan(out[vv]).all(), f"row {vv} written twice"
            out[vv] = 0.0
            continue
        p0, p1 = s // P, (e - 1) // P
        if p0 == p1:
            continue
        a = p0 + 1
        ga, gz = a // G, p1 // G
        head = gpre[ga] if a % G == 0 else gsuf[ga]
        if ga < gz or a % G == 0 or p1 == min(npieces, (ga + 1) * G) - 1:
            rows = np.stack([last[p0], head] + [gpre[q] for q in range(ga + 1, gz + 1)])
        else:
            rows = np.concatenate([last[p0][None], first[a:p1 + 1]])
        assert not np.isnan(rows).any(), f"row {vv} reads a partial nothing wrote"
        assert np.isnan(out[vv]).all(), f"row {vv} written twice"
        out[vv] = _kahan(rows)
    assert not np.isnan(out).any(), "a row of the table gradient was never written"
    return out


def edge_ids(rng, v, ids=64):
    """Ids whose sorted segments start and end on piece and group edges and
    just off them: ids 0 .. ``ids`` - 1 (below V) each repeated a count
    drawn from multiples of the piece and group sizes, one off them, and a
    few small and empty counts, in a random order."""
    counts = [2 * P * G, P * G, P * G - P, P * G + 1, G * P - 1, 3 * P, P, P - 1, P + 1, 1, 2,
              0, 0, 5 * P + 7]
    reps = rng.choice(counts, size=min(ids, v))
    out = np.repeat(np.arange(reps.size), reps)
    return out[rng.permutation(out.size)]
