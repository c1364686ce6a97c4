"""The repository's experiment configs as dicts, so a run needs no yaml
reader (the card's machine has no PyYAML): ``REFERENCE`` holds the keys
of the root ``config.yaml``, ``ML1M_PAPER``, ``BEAUTY_PAPER`` and
``XLONG_PAPER`` those of ``configs/paper/config_{ml1m,beauty,xlong}_paper.yaml``,
and ``PER_DATASET`` those of the six per-dataset sweep configs
``configs/config_<dataset>.yaml`` (the presets ``amazon-apps``,
``amazon-beauty``, ``amazon-sports``, ``hm``, ``ml-1m``, ``yelp``).

``config_layers(spec)`` turns a ``--config`` argument into a
``Config``'s layers: a preset's name, or the path of the repository's
yaml file that a preset mirrors, gives the dict; any other path is read
as a yaml file.
"""

from __future__ import annotations

import copy
import os

_FIELDS = {
    "USER_ID_FIELD": "user_id",
    "ITEM_ID_FIELD": "item_id",
    "load_col": {"inter": ["user_id", "item_id", "timestamp"]},
    "user_inter_num_interval": "[5,inf)",
    "item_inter_num_interval": "[5,inf)",
}
_RECBLR = {"hidden_size": 64, "num_layers": 2, "dropout_prob": 0.2, "loss_type": "CE",
           "expand": 2, "d_conv": 4}
_TRAIN = {"train_batch_size": 2048, "learner": "adam", "learning_rate": 0.001,
          "eval_step": 1, "stopping_step": 10, "train_neg_sample_args": None}
_EVAL = {"metrics": ["Hit", "NDCG", "MRR"], "valid_metric": "NDCG@10",
         "eval_batch_size": 4096, "weight_decay": 0.0, "topk": [10, 20]}

REFERENCE = {
    "bd_lru_only": False, "disable_conv1d": False, "disable_ffn": False,
    **_RECBLR, "dataset": "amazon-beauty", "MAX_ITEM_LIST_LENGTH": 200, **_FIELDS,
    "epochs": 100, **_TRAIN, **_EVAL,
}
ML1M_PAPER = {**_RECBLR, "dataset": "ml-1m", "MAX_ITEM_LIST_LENGTH": 200, **_FIELDS,
              "epochs": 200, **_TRAIN, **_EVAL}
BEAUTY_PAPER = {**_RECBLR, "dropout_prob": 0.5, "dataset": "amazon-beauty",
                "MAX_ITEM_LIST_LENGTH": 50, **_FIELDS, "epochs": 200, **_TRAIN, **_EVAL}
XLONG_PAPER = {**_RECBLR, "dataset": "xlong", "MAX_ITEM_LIST_LENGTH": 1024, **_FIELDS,
               "compute_dtype": "bfloat16", "epochs": 100, **_TRAIN,
               "train_batch_size": 512, **_EVAL, "eval_batch_size": 1024}


def _sweep(dataset, **over):
    """A per-dataset sweep config: the reference model at T 200, 10 epochs."""
    return {**_RECBLR, "dataset": dataset, "MAX_ITEM_LIST_LENGTH": 200, **_FIELDS,
            "epochs": 10, **_TRAIN, **_EVAL, **over}


PER_DATASET = {
    "amazon-apps": _sweep("amazon-apps", user_inter_num_interval="[0,inf)",
                          item_inter_num_interval="[0,inf)"),
    "amazon-beauty": _sweep("amazon-beauty"),
    "amazon-sports": _sweep("amazon-sports"),
    # H&M: one layer, dropout 0.4, T 50, the MAP@12 protocol
    "hm": _sweep("hm", num_layers=1, dropout_prob=0.4, MAX_ITEM_LIST_LENGTH=50, epochs=100,
                 metrics=["MAP", "NDCG", "MRR"], valid_metric="MAP@12", topk=[10, 12]),
    "ml-1m": _sweep("ml-1m"),
    "yelp": _sweep("yelp"),
}

PRESETS = {"reference": REFERENCE, "ml1m-paper": ML1M_PAPER,
           "beauty-paper": BEAUTY_PAPER, "xlong-paper": XLONG_PAPER, **PER_DATASET}
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the yaml file each preset mirrors, relative to the repository's root
PRESET_FILES = {
    "config.yaml": "reference",
    os.path.join("configs", "paper", "config_ml1m_paper.yaml"): "ml1m-paper",
    os.path.join("configs", "paper", "config_beauty_paper.yaml"): "beauty-paper",
    os.path.join("configs", "paper", "config_xlong_paper.yaml"): "xlong-paper",
    **{os.path.join("configs", f"config_{name.replace('-', '_')}.yaml"): name
       for name in PER_DATASET},
}


def preset(name: str) -> dict:
    """A copy of the preset ``name`` (a key of ``PRESETS``)."""
    return copy.deepcopy(PRESETS[name])


def config_layers(spec: str) -> tuple[list[str], dict]:
    """(yaml files, dict) for ``Config(config_file_list=..., config_dict=...)``
    from a preset name, a preset's yaml path, or another yaml file."""
    if spec in PRESETS:
        return [], preset(spec)
    for rel, name in PRESET_FILES.items():
        if os.path.realpath(spec) == os.path.realpath(os.path.join(_ROOT, rel)):
            return [], preset(name)
    if not os.path.exists(spec):
        raise FileNotFoundError(f"{spec!r} is neither a preset ({sorted(PRESETS)}) "
                                "nor a yaml file")
    return [spec], {}
