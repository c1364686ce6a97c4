"""Content-based item similarity for the cold-start pipeline (counterpart
of ``datamining_recblr_tpu/unseen/similarity.py``) on numpy and scipy,
without sklearn: TF-IDF over the item descriptions, a randomized
truncated SVD to ``n_components``, and the cosine similarity of an item
against the training-vocabulary ("valid") items; an unseen item maps to
its most similar valid item.

Each step computes what the JAX package's sklearn call computes, with the
same numpy and scipy operations in the same order:

* ``TfidfVectorizer()``: lowercase, tokens ``(?u)\\b\\w\\w+\\b``, the
  vocabulary sorted, raw counts times the smooth idf
  ``ln((1 + n) / (1 + df)) + 1``, rows scaled to unit l2 norm, fp64; the
  CSR entries of a row kept in the order of first appearance in the
  corpus, as sklearn stores them;
* ``TruncatedSVD(k, n_iter=3, random_state=seed)``: the randomized range
  finder (Gaussians from ``RandomState(seed).normal`` of size
  (columns, k + 10), three LU-normalised power iterations, then QR; the
  matrix transposed when it has fewer rows than columns), the SVD of the
  projection (``gesdd``), the sign of each component set by its largest
  loading (``svd_flip(u_based_decision=False)``), and the items projected
  on the components, ``X @ Vt.T`` (sklearn's randomized branch; not
  ``U * S``, which the approximation error makes differ);
* ``cosine_similarity``: rows scaled to unit norm, a norm below ten
  machine epsilons taken as 1 (zero rows stay zero), then one product
  for the whole [items, valid items] matrix.

Items with the same description get bit-equal rows, so ``nearest_valid``
is decided by ties, broken as ``np.argmax`` breaks them (the first valid
item).  A row computed alone (a matrix-vector product, or a block of the
matrix) can round differently from the same row of the whole product
and break those ties otherwise, so the matrix is computed whole, as the
JAX package does (0.82 GB in fp64 at beauty-synth's 10,544 x 9,702).
"""

from __future__ import annotations

import re

import numpy as np
from scipy import linalg
from scipy.sparse import csr_matrix

_TOKEN = re.compile(r"(?u)\b\w\w+\b")
_EPS10 = 10 * np.finfo(np.float64).eps


def tfidf_matrix(docs):
    """([len(docs), vocab] CSR fp64 tf-idf matrix, sorted vocabulary)."""
    vocab: dict[str, int] = {}
    rows = []
    for doc in docs:
        counts: dict[int, int] = {}
        for tok in _TOKEN.findall(doc.lower()):
            j = vocab.setdefault(tok, len(vocab))
            counts[j] = counts.get(j, 0) + 1
        rows.append(sorted(counts.items()))
    if not vocab:
        raise ValueError("empty vocabulary; perhaps the documents only contain stop words")
    names = sorted(vocab)
    remap = np.empty(len(names), np.int32)
    remap[[vocab[t] for t in names]] = np.arange(len(names), dtype=np.int32)
    lens = np.array([len(r) for r in rows], np.int64)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    first = np.fromiter((j for r in rows for j, _ in r), np.int32, int(lens.sum()))
    data = np.fromiter((c for r in rows for _, c in r), np.float64, int(lens.sum()))
    indices = remap[first]
    n = len(rows)
    df = np.bincount(indices, minlength=len(names)).astype(np.float64)
    idf = np.full_like(df, n + 1.0)
    idf /= df + 1.0
    idf = np.log(idf) + 1.0
    data *= idf[indices]
    # each row's sum of squares in storage order, as sklearn's loop sums it
    sq = data * data
    norm = np.zeros(n)
    for j in range(int(lens.max()) if n else 0):
        has = lens > j
        norm[has] += sq[indptr[:-1][has] + j]
    norm = np.sqrt(norm)
    scale = np.repeat(np.where(norm == 0.0, 1.0, norm), lens)
    data /= scale
    return csr_matrix((data, indices, indptr), shape=(n, len(names))), names


def truncated_svd(m, n_components: int, seed: int, n_iter: int = 3, n_oversamples: int = 10):
    """``TruncatedSVD(n_components, n_iter=n_iter, random_state=seed)
    .fit_transform(m)`` for a CSR ``m`` with n_iter above 2 (the LU
    power iterations): [rows, n_components] fp64, ``m @ Vt.T``."""
    n_samples, n_features = m.shape
    if n_features < 2:
        raise ValueError(f"Found array with {n_features} feature(s) while a minimum of 2 "
                         "is required by TruncatedSVD.")
    if n_components > n_features:
        raise ValueError(f"n_components({n_components}) must be <= n_features({n_features}).")
    rng = np.random.RandomState(seed)
    transpose = n_samples < n_features
    a = m.T if transpose else m
    q = rng.normal(size=(a.shape[1], n_components + n_oversamples))
    for _ in range(n_iter):
        q = linalg.lu(a @ q, permute_l=True, check_finite=False)[0]
        q = linalg.lu(a.T @ q, permute_l=True, check_finite=False)[0]
    q = linalg.qr(a @ q, mode="economic", check_finite=False)[0]
    uhat, _, vt = linalg.svd(q.T @ a, full_matrices=False, lapack_driver="gesdd")
    u = q @ uhat
    k = n_components
    vt = u[:, :k].T if transpose else vt[:k]
    vt = vt * np.sign(vt[np.arange(k), np.abs(vt).argmax(axis=1)])[:, None]
    return m @ vt.T


def unit_rows(x: np.ndarray) -> np.ndarray:
    """Rows scaled to unit l2 norm (sklearn's ``normalize``)."""
    norms = np.sqrt(np.einsum("ij,ij->i", x, x))
    norms[norms < _EPS10] = 1.0
    return x / norms[:, None]


class ItemSimilarity:
    def __init__(self, item_features: dict, valid_tokens: list[str], n_components: int = 16,
                 seed: int = 42):
        """``item_features``: a frame with the columns ``item_id`` and
        ``description``; ``valid_tokens``: the training vocabulary in id
        order."""
        ids = np.asarray(item_features["item_id"]).astype(str)
        order = np.argsort(ids, kind="stable")
        self.item_index = {t: i for i, t in enumerate(ids[order].tolist())}
        docs = np.asarray(item_features["description"]).astype(str)[order].tolist()
        tfidf, _ = tfidf_matrix(docs)
        n_components = max(min(n_components, tfidf.shape[1] - 1, len(docs) - 1), 1)
        x = truncated_svd(tfidf, n_components, seed)
        self.valid_tokens = [t for t in valid_tokens if t in self.item_index]
        valid_rows = [self.item_index[t] for t in self.valid_tokens]
        # [n_items, n_valid] fp64 cosine similarities
        self.sim = unit_rows(x) @ unit_rows(x[valid_rows]).T
        # token -> its nearest valid item, for each token looked up so far
        self.mapped: dict[str, str] = {}

    def nearest_valid(self, token: str) -> str | None:
        """The most similar training-vocabulary item (the first of equal
        maxima, as ``np.argmax``); None when the token has no feature
        row."""
        if token in self.mapped:
            return self.mapped[token]
        row = self.item_index.get(token)
        if row is None or not self.valid_tokens:
            return None
        best = self.valid_tokens[int(np.argmax(self.sim[row]))]
        self.mapped[token] = best
        return best

    def map_sequence(self, tokens: list[str], valid_set: set[str]) -> list[str]:
        """Each unseen token mapped to its nearest valid item; tokens
        without features are dropped."""
        out = []
        for t in tokens:
            if t in valid_set:
                out.append(t)
            else:
                m = self.nearest_valid(t)
                if m is not None:
                    out.append(m)
        return out
