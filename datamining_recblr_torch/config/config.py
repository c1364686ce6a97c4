"""Layered configuration system with RecBole-compatible key names.

The reference delegates configuration to RecBole's ``Config`` (see
reference ``run.py:38-39``): layered resolution of builtin defaults <-
per-model defaults <- yaml file list <- explicit dict <- CLI args, with
the final mapping dumped at the start of every run.  This module
re-implements that capability natively (no RecBole) with the same key
names so that the reference's yaml files (e.g. reference
``config.yaml``, ``configs/*.yaml``) load unchanged.

This is the PyTorch port's own copy of ``datamining_recblr_tpu/config``;
PyYAML is imported only when a yaml file is read, so a config built
from a dict needs no yaml package.
"""

from __future__ import annotations

import copy
from typing import Any, Iterable, Mapping

# ---------------------------------------------------------------------------
# Builtin defaults: the subset of RecBole defaults the reference exercises,
# pinned by the config dump in the reference run logs
# (log/RecBLR/RecBLR-amazon-beauty-Nov-23-2025_12-40-09-6bcfda.log:2-107).
# ---------------------------------------------------------------------------
_GENERAL_DEFAULTS: dict[str, Any] = {
    "seed": 2020,
    "reproducibility": True,
    "checkpoint_dir": "saved",
    "data_path": "dataset",
    "log_dir": "log",
    "show_progress": False,
    "log_wandb": False,
    # dataset / field settings
    "dataset": None,
    "USER_ID_FIELD": "user_id",
    "ITEM_ID_FIELD": "item_id",
    "TIME_FIELD": "timestamp",
    "ITEM_LIST_LENGTH_FIELD": "item_length",
    "LIST_SUFFIX": "_list",
    "MAX_ITEM_LIST_LENGTH": 50,
    "load_col": {"inter": ["user_id", "item_id", "timestamp"]},
    "user_inter_num_interval": "[0,inf)",
    "item_inter_num_interval": "[0,inf)",
    # split protocol (leave-one-out, time-ordered, grouped by user,
    # full-catalog ranking) — log:31
    "eval_args": {
        "split": {"LS": "valid_and_test"},
        "order": "TO",
        "group_by": "user",
        "mode": "full",
    },
    # training settings
    "epochs": 100,
    "train_batch_size": 2048,
    "learner": "adam",
    "learning_rate": 1e-3,
    "weight_decay": 0.0,
    "eval_step": 1,
    "stopping_step": 10,
    "train_neg_sample_args": None,
    "loss_type": "CE",
    # evaluation settings
    "metrics": ["Hit", "NDCG", "MRR"],
    "topk": [10, 20],
    "valid_metric": "NDCG@10",
    "valid_metric_bigger": True,
    "eval_batch_size": 4096,
    # TPU-native additions (not in RecBole)
    "compute_dtype": "float32",   # bfloat16 for speed, float32 for parity
    "param_dtype": "float32",
    "prng_impl": "rbg",           # rbg: fast TPU dropout; threefry2x32: portable

    "use_pallas_scan": "auto",    # auto | always | never
    "mesh_shape": None,           # e.g. {"data": 4, "model": 2}; None = single device
    "vocab_row_shard": "auto",    # auto (element-count policy) | always | never
    "mesh_input": "resident",     # resident: split replicated on device, index
                                  # vectors per step | stream: host batches per step
    "multihost": False,           # call jax.distributed.initialize at program start
    "multihost_args": None,       # kwargs for jax.distributed.initialize
    "metrics_file": None,         # JSONL structured metrics sink
    "mask_history": False,        # RecBole sequential full-sort eval does NOT
                                  # mask training history (only PAD item 0)
}

# Per-model defaults, mirroring the RecBole model property files the
# reference relies on (values confirmed by the reference's own model code:
# RecBLR.py:22-30, sasrec.py:40-52, bert4rec.py:38-57).
_MODEL_DEFAULTS: dict[str, dict[str, Any]] = {
    "RecBLR": {
        "hidden_size": 64,
        "num_layers": 2,
        "dropout_prob": 0.2,
        "expand": 2,
        "d_conv": 4,
        "bd_lru_only": False,
        "disable_conv1d": False,
        "disable_ffn": False,
    },
    "SASRec": {
        "n_layers": 2,
        "n_heads": 2,
        "hidden_size": 64,
        "inner_size": 256,
        "hidden_dropout_prob": 0.5,
        "attn_dropout_prob": 0.5,
        "hidden_act": "gelu",
        "layer_norm_eps": 1e-12,
        "initializer_range": 0.02,
    },
    "BERT4Rec": {
        "n_layers": 2,
        "n_heads": 2,
        "hidden_size": 64,
        "inner_size": 256,
        "hidden_dropout_prob": 0.2,
        "attn_dropout_prob": 0.2,
        "hidden_act": "gelu",
        "layer_norm_eps": 1e-12,
        "initializer_range": 0.02,
        "mask_ratio": 0.2,
        "MASK_ITEM_SEQ": "Mask_item_seq",
        "POS_ITEMS": "Pos_items",
        "NEG_ITEMS": "Neg_items",
        "MASK_INDEX": "Mask_index",
    },
}


def _deep_update(base: dict, update: Mapping) -> dict:
    for k, v in update.items():
        if isinstance(v, Mapping) and isinstance(base.get(k), dict):
            base[k] = _deep_update(base[k], v)
        else:
            base[k] = copy.deepcopy(v) if isinstance(v, (dict, list)) else v
    return base


class Config:
    """Layered config: builtin <- model defaults <- yaml files <- dict.

    Usage mirrors the reference entry script (``run.py:38-39``)::

        config = Config(model="RecBLR", config_file_list=["config.yaml"])
        config["hidden_size"]           # -> 64
    """

    def __init__(
        self,
        model: str = "RecBLR",
        dataset: str | None = None,
        config_file_list: Iterable[str] | None = None,
        config_dict: Mapping[str, Any] | None = None,
    ):
        final: dict[str, Any] = copy.deepcopy(_GENERAL_DEFAULTS)
        final["model"] = model
        _deep_update(final, copy.deepcopy(_MODEL_DEFAULTS.get(model, {})))
        for path in config_file_list or []:
            import yaml

            with open(path) as f:
                loaded = yaml.safe_load(f) or {}
            _deep_update(final, loaded)
        if config_dict:
            _deep_update(final, config_dict)
        if dataset is not None:
            final["dataset"] = dataset
        self._cfg = final

    # Mapping-style access (RecBole's Config supports __getitem__/get/in).
    def __getitem__(self, key: str) -> Any:
        return self._cfg.get(key)

    def __setitem__(self, key: str, value: Any) -> None:
        self._cfg[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._cfg

    def get(self, key: str, default: Any = None) -> Any:
        return self._cfg.get(key, default)

    def as_dict(self) -> dict[str, Any]:
        return copy.deepcopy(self._cfg)

    def update(self, other: Mapping[str, Any]) -> None:
        _deep_update(self._cfg, other)

    @property
    def model(self) -> str:
        return self._cfg["model"]

    def __repr__(self) -> str:
        lines = [f"Config(model={self._cfg.get('model')}, dataset={self._cfg.get('dataset')})"]
        for k in sorted(self._cfg):
            lines.append(f"  {k} = {self._cfg[k]!r}")
        return "\n".join(lines)


def model_defaults(model: str) -> dict[str, Any]:
    return copy.deepcopy(_MODEL_DEFAULTS.get(model, {}))
