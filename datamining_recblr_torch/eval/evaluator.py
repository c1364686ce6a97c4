"""Batched evaluator (counterpart of
``datamining_recblr_tpu/eval/evaluator.py``), in RecBole's
``eval_args.mode``:

* ``full``: for each eval batch the model's [B, V] catalog scores, PAD
  (and optionally the user's training history) masked to -inf, the
  target ranks and the metric sums, kept on the device until one
  transfer at the end;
* ``uniN`` / ``popN``: the target ranked among itself and N negatives,
  uniform in [1, n_items) or drawn by training popularity
  (``set_item_popularity``), from ``default_rng(seed)`` anew for each
  ``evaluate`` call, batch by batch, with up to 4 rounds of resampling
  where a negative equals the target; the candidates hold the target at
  index 0, so a tie ranks it first; BERT4Rec's scores add its output
  bias.  The draws are the JAX package's, in its order.

On a mesh (``mesh``, with the model sharded by ``parallel.sharding``)
each data rank scores rows [d B/D, (d+1) B/D) of every global batch
(``eval_batch_size`` must divide by ``data``), the candidates still drawn
for the global batch; a row-sharded table's scores stay sharded over
``model`` (``target_ranks`` reduces over it); the seq ranks of a data
index each run their time chunk of its rows and hold the same scores;
and the metric sums are summed over ``data`` alone at the end (a sum
over ``seq`` would count each row S times), so every rank returns the
global metrics.
"""

from __future__ import annotations

import numpy as np
import torch

from datamining_recblr_torch.data.batching import iter_batches
from datamining_recblr_torch.eval.metrics import mask_scores, rank_metrics, target_ranks
from datamining_recblr_torch.parallel.collectives import all_reduce
from datamining_recblr_torch.parallel.mesh import DATA_AXIS
from datamining_recblr_torch.parallel.sharding import shard_batch


def history_fn_from_data(data):
    """user ids [B] -> [B, n_items] bool mask of the items each user saw
    in training (from SeqData.user_train_items)."""

    def fn(user_ids: np.ndarray) -> np.ndarray:
        mask = np.zeros((len(user_ids), data.n_items), bool)
        for j, u in enumerate(user_ids):
            items = data.user_train_items[int(u)]
            if len(items):
                mask[j, items] = True
        return mask

    return fn


class Evaluator:
    def __init__(self, model, config, mesh=None):
        self.model = model
        self.mesh = mesh
        self.metrics = [m.lower() for m in config["metrics"]]
        self.topk = [int(k) for k in config["topk"]]
        self.batch_size = int(config["eval_batch_size"])
        if mesh is not None and self.batch_size % mesh.size(DATA_AXIS):
            raise ValueError(f"eval_batch_size {self.batch_size} must divide by the data "
                             f"mesh axis ({mesh.size(DATA_AXIS)})")
        self.seed = int(config.get("seed", 0) or 0)
        mode = str((config.get("eval_args") or {}).get("mode", "full"))
        self.n_negatives = None
        self.pop_sampling = False
        if mode.startswith("uni") or mode.startswith("pop"):
            self.n_negatives = int(mode[3:])
            self.pop_sampling = mode.startswith("pop")
        elif mode != "full":
            raise ValueError(f"unsupported eval mode {mode!r} (full / uniN / popN)")
        self.pop_probs = None

    def set_item_popularity(self, counts):
        """counts: per-item interaction counts indexed by item id (PAD at
        0), the popN sampling distribution."""
        c = np.zeros(self.model.n_items, np.float64)
        c[: len(counts)] = np.asarray(counts, np.float64)[: self.model.n_items]
        c[0] = 0.0
        total = c.sum()
        self.pop_probs = c / total if total else None

    def _draw(self, rng, size):
        if self.pop_sampling:
            return rng.choice(self.model.n_items, size=size, p=self.pop_probs)
        return rng.integers(1, self.model.n_items, size=size)

    def candidates(self, rng, pos):
        """[B, 1 + N] candidate ids: the targets ``pos`` [B] at index 0,
        then N negatives."""
        if self.pop_sampling:
            assert self.pop_probs is not None, "popN eval mode requires set_item_popularity(counts)"
        neg = self._draw(rng, (len(pos), self.n_negatives)).astype(np.int32)
        for _ in range(4):
            coll = neg == pos[:, None]
            if not coll.any():
                break
            neg[coll] = self._draw(rng, int(coll.sum()))
        return np.concatenate([pos[:, None], neg], axis=1)

    def sampled_scores(self, item_seq, item_seq_len, cands):
        """[B, 1 + N] fp32 scores of the candidates: the compute-dtype
        operands multiplied in fp32, plus BERT4Rec's output bias."""
        model = self.model
        seq_output = model(item_seq, item_seq_len)
        emb = model.rows_of("item_embedding", cands).to(seq_output.dtype)
        scores = torch.einsum("bh,bnh->bn", seq_output.float(), emb.float())
        if hasattr(model, "mask_token"):
            scores = scores + model.rows_of("output_bias", cands)
        return scores

    def batch_sums(self, put, history=None):
        """Metric sums of one batch on this rank: ``put`` holds item_seq,
        item_seq_len, pos_item and weight tensors (and ``cands`` in the
        sampled modes); ``history`` a [B, V] bool mask of the catalog's
        columns."""
        if "cands" in put:
            scores = self.sampled_scores(put["item_seq"], put["item_seq_len"], put["cands"])
            ranks = target_ranks(scores, torch.zeros_like(put["pos_item"]))
            return rank_metrics(ranks, self.metrics, self.topk, put["weight"])
        model = self.model
        scores = model.full_sort_scores(put["item_seq"], put["item_seq_len"])
        lo, hi = model.score_cols()
        if history is not None:  # to this rank's columns; padded ones are -inf already
            history = torch.nn.functional.pad(history, (0, max(0, hi - history.shape[-1])))
            history = history[:, lo:hi]
        scores = mask_scores(scores, history=history, col0=lo)
        ranks = target_ranks(scores, put["pos_item"], col0=lo, mesh=model.score_mesh())
        return rank_metrics(ranks, self.metrics, self.topk, put["weight"])

    def evaluate(self, split, history_fn=None) -> dict[str, float]:
        """{"metric@k": value} averaged over real rows, keys sorted, with the
        model's current parameters."""
        model = self.model
        dev = model.device
        was_training = model.training
        model.eval()
        sums = {}
        neg_rng = np.random.default_rng(self.seed) if self.n_negatives is not None else None
        with torch.no_grad():
            for batch in iter_batches(split, self.batch_size):
                if neg_rng is not None:  # drawn for the global batch
                    batch["cands"] = self.candidates(neg_rng, batch["pos_item"])
                keys = ("item_seq", "item_seq_len", "pos_item", "weight", "cands", "user_id")
                mine = shard_batch({k: np.asarray(batch[k]) for k in keys if k in batch},
                                   self.mesh)
                user_id = mine.pop("user_id", None)
                put = {k: torch.from_numpy(v).to(dev) for k, v in mine.items()}
                hist = None
                if history_fn is not None:
                    hist = torch.from_numpy(history_fn(user_id)).to(dev)
                for key, (sv, wv) in self.batch_sums(put, hist).items():
                    cur = sums.get(key)
                    sums[key] = (sv, wv) if cur is None else (cur[0] + sv, cur[1] + wv)
        model.train(was_training)
        sums = sum_over_data(sums, self.mesh)
        out = {}
        for k, (sv, wv) in sorted(sums.items()):  # key order as the JAX package's
            w = float(wv)
            out[k] = float(sv) / w if w else 0.0
        return out


def sum_over_data(sums: dict, mesh) -> dict:
    """Metric sums {key: (sum, weight sum)} summed over the ``data`` ranks
    in one all-reduce (unchanged off a mesh)."""
    if mesh is None or not sums:
        return sums
    keys = sorted(sums)
    flat = all_reduce(torch.stack([v for k in keys for v in sums[k]]), mesh, DATA_AXIS)
    return {k: (flat[2 * i], flat[2 * i + 1]) for i, k in enumerate(keys)}


def format_result(result: dict[str, float]) -> str:
    """4-decimal reporting, like the reference logs."""
    return "  ".join(f"{k}: {v:.4f}" for k, v in sorted(result.items()))
