"""Batched full-sort evaluator (counterpart of the ``full`` mode of
``datamining_recblr_tpu/eval/evaluator.py``): for each eval batch the
model's [B, V] catalog scores, PAD (and optionally the user's training
history) masked to -inf, the target ranks and the metric sums, kept on
the device until one transfer at the end.  The sampled ``uniN`` /
``popN`` modes are not ported yet."""

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
        mode = str((config.get("eval_args") or {}).get("mode", "full"))
        if mode != "full":
            raise NotImplementedError(f"eval mode {mode!r} is not ported; full is")

    def evaluate(self, split, history_fn=None) -> dict[str, float]:
        """{"metric@k": value} averaged over real rows, with the model's
        current parameters."""
        model = self.model
        dev = model.device
        was_training = model.training
        model.eval()
        sums = {}
        with torch.no_grad():
            for batch in iter_batches(split, self.batch_size):
                put = {k: torch.from_numpy(np.asarray(batch[k])).to(dev)
                       for k in ("item_seq", "item_seq_len", "pos_item", "weight")}
                scores = model.full_sort_scores(put["item_seq"], put["item_seq_len"])
                hist = None
                if history_fn is not None:
                    hist = torch.from_numpy(history_fn(batch["user_id"])).to(dev)
                    pad = scores.shape[-1] - hist.shape[-1]
                    if pad:  # padded vocab columns are -inf already
                        hist = torch.nn.functional.pad(hist, (0, pad))
                scores = mask_scores(scores, history=hist)
                ranks = target_ranks(scores, put["pos_item"])
                for key, (sv, wv) in rank_metrics(ranks, self.metrics, self.topk,
                                                  put["weight"]).items():
                    cur = sums.get(key)
                    sums[key] = (sv, wv) if cur is None else (cur[0] + sv, cur[1] + wv)
        model.train(was_training)
        out = {}
        for k, (sv, wv) in sums.items():
            w = float(wv)
            out[k] = float(sv) / w if w else 0.0
        return out


def format_result(result: dict[str, float]) -> str:
    """4-decimal reporting, like the reference logs."""
    return "  ".join(f"{k}: {v:.4f}" for k, v in sorted(result.items()))
