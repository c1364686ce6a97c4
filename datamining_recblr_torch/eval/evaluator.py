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
"""

from __future__ import annotations

import numpy as np
import torch

from datamining_recblr_torch.data.batching import iter_batches
from datamining_recblr_torch.eval.metrics import mask_scores, rank_metrics, target_ranks


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
    def __init__(self, model, config):
        self.model = model
        self.metrics = [m.lower() for m in config["metrics"]]
        self.topk = [int(k) for k in config["topk"]]
        self.batch_size = int(config["eval_batch_size"])
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
        emb = model.item_embedding[cands].to(seq_output.dtype)
        scores = torch.einsum("bh,bnh->bn", seq_output.float(), emb.float())
        if hasattr(model, "mask_token"):
            scores = scores + model.output_bias[cands]
        return scores

    def _accumulate(self, sums, ranks, weight):
        for key, (sv, wv) in rank_metrics(ranks, self.metrics, self.topk, weight).items():
            cur = sums.get(key)
            sums[key] = (sv, wv) if cur is None else (cur[0] + sv, cur[1] + wv)

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
                put = {k: torch.from_numpy(np.asarray(batch[k])).to(dev)
                       for k in ("item_seq", "item_seq_len", "pos_item", "weight")}
                if neg_rng is not None:
                    cands = torch.from_numpy(self.candidates(neg_rng, batch["pos_item"])).to(dev)
                    scores = self.sampled_scores(put["item_seq"], put["item_seq_len"], cands)
                    ranks = target_ranks(scores, torch.zeros_like(put["pos_item"]))
                    self._accumulate(sums, ranks, put["weight"])
                    continue
                scores = model.full_sort_scores(put["item_seq"], put["item_seq_len"])
                hist = None
                if history_fn is not None:
                    hist = torch.from_numpy(history_fn(batch["user_id"])).to(dev)
                    pad = scores.shape[-1] - hist.shape[-1]
                    if pad:  # padded vocab columns are -inf already
                        hist = torch.nn.functional.pad(hist, (0, pad))
                scores = mask_scores(scores, history=hist)
                self._accumulate(sums, target_ranks(scores, put["pos_item"]), put["weight"])
        model.train(was_training)
        out = {}
        for k, (sv, wv) in sorted(sums.items()):  # key order as the JAX package's
            w = float(wv)
            out[k] = float(sv) / w if w else 0.0
        return out


def format_result(result: dict[str, float]) -> str:
    """4-decimal reporting, like the reference logs."""
    return "  ".join(f"{k}: {v:.4f}" for k, v in sorted(result.items()))
