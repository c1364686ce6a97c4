"""Serving path: batched top-k recommendation from a model (counterpart
of ``datamining_recblr_tpu/serve.py``).

One ``recommend`` call builds the [B, T] window batch on the host, runs
``full_sort_scores`` (on the card: one launch of each fused layer
kernel, then the fp32 scoring product), masks PAD, padded vocab and
each user's history to -inf, and takes the top k."""

from __future__ import annotations

import numpy as np
import torch

from datamining_recblr_torch.config import Config
from datamining_recblr_torch.eval.metrics import mask_scores
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.ops.topk import topk_scores
from datamining_recblr_torch.train.checkpoint import restore_checkpoint


class Recommender:
    def __init__(self, model, params=None, top_k: int = 10):
        """``params``: a state_dict to load into ``model`` (None keeps the
        model's own parameters)."""
        self.model = model
        if params is not None:
            model.load_state_dict(params)
        model.eval()
        self.top_k = int(top_k)

    @classmethod
    def from_checkpoint(
        cls, checkpoint_path: str, config: Config, n_items: int,
        max_seq_len: int, top_k: int = 10, device=None,
    ) -> "Recommender":
        model = get_model(config["model"])(config, n_items, max_seq_len, device=device)
        state = restore_checkpoint(checkpoint_path)
        return cls(model, state["params"], top_k=top_k)

    def recommend(self, sequences, exclude_history: bool = True):
        """sequences: list of per-user item-id lists (most recent last).

        Returns (item_ids [B, k] int32, scores [B, k] float32) as NumPy
        arrays; the PAD item and (optionally) every item of each user's
        history, not only of the window, are excluded."""
        model = self.model
        b = len(sequences)
        t = model.max_seq_len
        seq = np.zeros((b, t), np.int64)
        lens = np.zeros((b,), np.int32)
        hist = np.zeros((b, model.n_items_padded), bool)
        for i, items in enumerate(sequences):
            window = np.asarray(items, np.int64)[-t:]
            seq[i, : len(window)] = window
            lens[i] = len(window)
            if exclude_history and len(items):
                hist[i, np.asarray(items, np.int64)] = True
        dev = model.device
        with torch.inference_mode():
            scores = model.full_sort_scores(
                torch.from_numpy(seq).to(dev), torch.from_numpy(lens).to(dev)
            )
            scores = mask_scores(scores, history=torch.from_numpy(hist).to(dev))
            vals, ids = topk_scores(scores, self.top_k)
        return ids.to(torch.int32).cpu().numpy(), vals.cpu().numpy()
