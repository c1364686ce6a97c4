"""Cold-start (unseen-user, unseen-item) experiment (counterpart of
``datamining_recblr_tpu/unseen/pipeline.py``), with numpy in place of
pandas:

1. a user-level split with a fixed seed (users in order of first
   appearance, shuffled by ``RandomState(seed)``), written as
   ``<ds>_train.inter`` / ``<ds>_test.inter`` and reused when both
   exist; the original ``.inter`` is left as it is;
2. ``run_experiment`` on the train users: training, and the seen-user
   test from the best checkpoint;
3. the held-out users evaluated in one batched pass, each user's
   time-sorted sequence minus its last item as the input and the last
   item as the target.  Mode ``pre`` maps history items missing from
   the training vocabulary to their most similar seen item
   (``similarity.ItemSimilarity``); mode ``none`` skips users whose
   history holds such an item.  Users whose target is missing from the
   vocabulary are skipped in both.

The held-out users are scored with the model's parameters after the last
epoch, as the JAX package scores them with ``trainer.params``
(``Trainer.evaluate(load_best=True)`` puts the trainer's own parameters
back after the seen-user test).
"""

from __future__ import annotations

import os
import time

import numpy as np

from datamining_recblr_torch.data.atomic import read_atomic_file, write_atomic_inter
from datamining_recblr_torch.data.dataset import SplitArrays, build_from_dataframe
from datamining_recblr_torch.drivers import run_experiment
from datamining_recblr_torch.eval.evaluator import Evaluator
from datamining_recblr_torch.run import build_config
from datamining_recblr_torch.unseen.features import (
    load_item_text_features,
    synthesize_item_features,
)
from datamining_recblr_torch.unseen.similarity import ItemSimilarity
from datamining_recblr_torch.utils.logging import init_logger


def prepare_data_split(config, test_size: float = 0.1, seed: int = 42):
    """Split the users ``1 - test_size`` / ``test_size``; write or reuse
    ``<ds>_train.inter`` / ``<ds>_test.inter``.  Returns (train, test)
    frames."""
    name = config["dataset"]
    ddir = os.path.join(config["data_path"], name)
    inter_file = os.path.join(ddir, f"{name}.inter")
    train_file = os.path.join(ddir, f"{name}_train.inter")
    test_file = os.path.join(ddir, f"{name}_test.inter")
    ufield, ifield, tfield = (config["USER_ID_FIELD"], config["ITEM_ID_FIELD"],
                              config["TIME_FIELD"])
    if os.path.exists(train_file) and os.path.exists(test_file):
        return read_atomic_file(train_file), read_atomic_file(test_file)

    df = read_atomic_file(inter_file, columns=[ufield, ifield, tfield])
    uniq, first = np.unique(df[ufield], return_index=True)
    users = uniq[np.argsort(first, kind="stable")]  # first-appearance order
    perm = np.arange(len(users))
    np.random.RandomState(seed).shuffle(perm)
    n_test = max(1, int(round(len(users) * test_size)))
    is_test = np.isin(df[ufield], users[perm[:n_test]])
    test_df = {k: v[is_test] for k, v in df.items()}
    train_df = {k: v[~is_test] for k, v in df.items()}
    write_atomic_inter(train_df, train_file, ufield, ifield, tfield)
    write_atomic_inter(test_df, test_file, ufield, ifield, tfield)
    return train_df, test_df


def build_unseen_split(test_df: dict, data, mode: str, similarity: ItemSimilarity | None,
                       user_field: str, item_field: str, time_field: str):
    """Per held-out user (in sorted order): input = sequence[:-1] (mapped
    per mode, the last ``max_seq_len`` items), target = last item.
    Returns (SplitArrays, n_total_users, n_evaluated)."""
    valid_set = set(data.item_token2id)
    users = np.asarray(test_df[user_field])
    order = np.lexsort((np.asarray(test_df[time_field]), users))
    users, items = users[order], np.asarray(test_df[item_field])[order]
    seqs = np.split(items, np.flatnonzero(users[1:] != users[:-1]) + 1) if len(users) else []
    rows = []
    for seq in seqs:
        seq = seq.tolist()
        if len(seq) < 2:
            continue
        target = seq[-1]
        if target not in valid_set:
            continue  # an unmappable target
        history = seq[:-1]
        if mode == "pre" and similarity is not None:
            history = similarity.map_sequence(history, valid_set)
            if not history:
                continue
        elif any(t not in valid_set for t in history):
            continue  # mode none: an item the model has no id for
        ids = [data.item_token2id[t] for t in history][-data.max_seq_len:]
        rows.append((ids, data.item_token2id[target]))

    n = len(rows)
    seq_arr = np.zeros((n, data.max_seq_len), np.int32)
    len_arr = np.zeros((n,), np.int32)
    tgt_arr = np.zeros((n,), np.int32)
    for j, (ids, tgt) in enumerate(rows):
        seq_arr[j, : len(ids)] = ids
        len_arr[j] = len(ids)
        tgt_arr[j] = tgt
    return SplitArrays(seq_arr, len_arr, tgt_arr, np.zeros((n,), np.int32)), len(seqs), n


def run_unseen_experiment(mode: str = "none", dataset: str | None = None,
                          config_files: list[str] | None = None, epochs: int | None = None,
                          n_components: int = 16, test_size: float = 0.1, config=None,
                          train_df: dict | None = None, test_df: dict | None = None,
                          plot_dir: str = "plot", device=None, params=None) -> dict:
    """The whole cold-start experiment on ``device`` (the card unless the
    caller names another; ``params``: initial parameters, as for
    ``run_experiment``).  ``config_files`` are ``--config`` specs
    (presets or yaml files).  Returns {mode, seen_result, unseen_result,
    n_unseen_users, n_evaluated, experiment}; the ``unseen_test``
    metrics record also holds ``n_mapped``, the unseen history items mode
    pre mapped to a seen one, and the seconds of the similarity
    (``similarity_s``: the item features, ``ItemSimilarity`` and the
    held-out split) and of the held-out evaluation (``eval_s``)."""
    logger = init_logger()
    if config is None:
        config = build_config("RecBLR", dataset, config_files or [],
                              {} if epochs is None else {"epochs": epochs})
    if train_df is None or test_df is None:
        train_df, test_df = prepare_data_split(config, test_size=test_size)

    data = build_from_dataframe(
        train_df, max_seq_len=config["MAX_ITEM_LIST_LENGTH"],
        user_field=config["USER_ID_FIELD"], item_field=config["ITEM_ID_FIELD"],
        time_field=config["TIME_FIELD"], user_interval=config["user_inter_num_interval"],
        item_interval=config["item_inter_num_interval"])
    result = run_experiment(config, data=data, plot_prefix=f"RecBLR_config_{mode}",
                            plot_dir=plot_dir, make_plots=True, device=device, params=params)
    seen_result = result["test_result"]
    logger.info(f"seen-user test: {seen_result}")

    t0 = time.perf_counter()
    similarity = None
    if mode == "pre":
        feats = load_item_text_features(config["dataset"] or "", config["data_path"])
        if feats is None:
            # train interactions cover only seen items; the test ones give
            # the unseen items their rows
            both = {k: np.concatenate([np.asarray(train_df[k]), np.asarray(test_df[k])])
                    for k in (config["ITEM_ID_FIELD"], config["USER_ID_FIELD"])}
            feats = synthesize_item_features(both, config["ITEM_ID_FIELD"],
                                             config["USER_ID_FIELD"])
        similarity = ItemSimilarity(feats, list(data.item_token2id), n_components=n_components,
                                    seed=int(config["seed"]))
    unseen_split, n_total, n_eval = build_unseen_split(
        test_df, data, mode, similarity, config["USER_ID_FIELD"], config["ITEM_ID_FIELD"],
        config["TIME_FIELD"])
    similarity_s = time.perf_counter() - t0
    logger.info(f"unseen-user eval (mode={mode}): {n_eval}/{n_total} users evaluable")

    t0 = time.perf_counter()
    evaluator = Evaluator(result["model"], _EvalCfg(config, metrics=["hit", "ndcg"], topk=[10]))
    unseen_result = (evaluator.evaluate(unseen_split) if n_eval
                     else {"hit@10": 0.0, "ndcg@10": 0.0})
    eval_s = time.perf_counter() - t0
    logger.info(f"unseen-user test (mode={mode}): {unseen_result}")
    result["metrics"].log("unseen_test", mode=mode, **unseen_result,
                          n_mapped=len(similarity.mapped) if similarity else 0,
                          similarity_s=similarity_s, eval_s=eval_s)
    return {
        "mode": mode,
        "seen_result": seen_result,
        "unseen_result": unseen_result,
        "n_unseen_users": n_total,
        "n_evaluated": n_eval,
        "experiment": result,
    }


class _EvalCfg:
    """Config view overriding metrics/topk for the unseen evaluator."""

    def __init__(self, config, metrics, topk):
        self._config = config
        self._over = {"metrics": metrics, "topk": topk}

    def __getitem__(self, key):
        if key in self._over:
            return self._over[key]
        return self._config[key]

    def get(self, key, default=None):
        if key in self._over:
            return self._over[key]
        return self._config.get(key, default)
