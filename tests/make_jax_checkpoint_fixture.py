"""Write ``tests/fixtures/jax_checkpoint/``: a checkpoint the JAX package
wrote, and what the JAX package does with it.

    JAX_PLATFORMS=cpu python tests/make_jax_checkpoint_fixture.py [OUT_DIR]

RecBLR at the bench serving width (hidden 64, 2 layers, d_conv 4, T 200;
dropout 0, fp32) over a synthetic log of about 500 items, fitted for one
epoch by the JAX ``Trainer`` with adam, its best checkpoint saved through
the JAX package's pickle path (orbax made unimportable, as
``tests/test_trainer_extras.py`` forces it): ``recblr.pkl``.  Beside it
``config.json`` (the config keys and the data's sizes) and
``expected.npz``, which ``expected(fixture_dir, batches)`` computes with
the JAX package:
* ``requests`` / ``request_lens``: user histories (empty ones, and ones
  longer than T, included) as padded rows;
* ``ids``, ``scores``: ``Recommender.from_checkpoint(...).recommend`` of
  them, top 10, through the fused layer kernels (``use_pallas_scan:
  always``, in interpret mode);
* ``item_seq``, ``item_seq_len``, ``pos_item``, ``weight``, ``steps``,
  ``losses``: three train batches drawn from the log and the losses of
  the three JAX train steps after ``Trainer.resume_from``.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FIXTURE = HERE / "fixtures" / "jax_checkpoint"
CONFIG = {"hidden_size": 64, "num_layers": 2, "d_conv": 4, "expand": 2,
          "MAX_ITEM_LIST_LENGTH": 200, "dropout_prob": 0.0, "compute_dtype": "float32",
          "learner": "adam", "learning_rate": 1e-3, "train_batch_size": 128,
          "eval_batch_size": 256, "epochs": 1, "stopping_step": 10, "dataset": "fixture",
          "use_pallas_scan": "never", "seed": 2020}
DATA = dict(n_users=240, n_items=500, min_len=5, max_len=60, markov_weight=0.9, n_clusters=20,
            seed=7)
N_REQUESTS, RESUME_STEPS, TOP_K = 12, 3, 10


def requests(n_items: int):
    """The request histories: two empty, one of a single item, the rest of
    lengths up to 260 (T is 200)."""
    rng = np.random.default_rng(11)
    lens = [0, 1, 0, 5, 37, 200, 201, 260, 17, 120, 2, 64][:N_REQUESTS]
    return [rng.integers(1, n_items, n).tolist() for n in lens]


def pad(histories):
    lens = np.array([len(h) for h in histories], np.int32)
    rows = np.zeros((len(histories), max(lens.max(), 1)), np.int32)
    for i, h in enumerate(histories):
        rows[i, : len(h)] = h
    return rows, lens


def unpad(rows, lens):
    return [rows[i, :n].tolist() for i, n in enumerate(lens)]


def expected(fixture_dir, batches) -> dict:
    """What the JAX package gives from the fixture's checkpoint: the
    request top-10 and the losses of the three resumed steps on
    ``batches`` (with JAX on the CPU)."""
    import jax
    import jax.numpy as jnp

    from datamining_recblr_tpu.config import Config
    from datamining_recblr_tpu.models import get_model
    from datamining_recblr_tpu.serve import Recommender
    from datamining_recblr_tpu.train import Trainer

    fixture_dir = Path(fixture_dir)
    meta = json.loads((fixture_dir / "config.json").read_text())
    cfg = Config(model="RecBLR", config_dict=dict(meta["config"], epochs=2))
    n_items, t = meta["n_items"], meta["config"]["MAX_ITEM_LIST_LENGTH"]
    ckpt = str(fixture_dir / "recblr.pkl")
    rows, lens = pad(requests(n_items))
    # served through the fused layer kernels (Pallas, in interpret mode
    # here), the composition of a TPU and of the port: an empty request
    # selects no position there, where the XLA composition reads T - 1
    fused = Config(model="RecBLR", config_dict=dict(meta["config"], use_pallas_scan="always"))
    ids, scores = Recommender.from_checkpoint(ckpt, fused, n_items, t,
                                              top_k=TOP_K).recommend(unpad(rows, lens))

    trainer = Trainer(cfg, get_model("RecBLR")(cfg, n_items, t))
    trainer.resume_from(ckpt)
    params, opt_state = trainer.params, trainer.opt_state
    losses = []
    for i, step in enumerate(batches["steps"]):
        batch = {k: jnp.asarray(batches[k][i])
                 for k in ("item_seq", "item_seq_len", "pos_item", "weight")}
        params, opt_state, loss = trainer._train_step_batch(params, opt_state, batch,
                                                            int(step))
        losses.append(float(loss))
    jax.block_until_ready(params)
    return {"requests": rows, "request_lens": lens, "ids": np.asarray(ids, np.int32),
            "scores": np.asarray(scores, np.float32), **batches,
            "losses": np.array(losses, np.float32)}


def write(out: Path):
    import jax

    from datamining_recblr_tpu.config import Config
    from datamining_recblr_tpu.data.batching import batch_count
    from datamining_recblr_tpu.data.dataset import build_from_dataframe
    from datamining_recblr_tpu.data.synthetic import generate_synthetic_interactions
    from datamining_recblr_tpu.models import get_model
    from datamining_recblr_tpu.train import Trainer

    out.mkdir(parents=True, exist_ok=True)
    t = CONFIG["MAX_ITEM_LIST_LENGTH"]
    data = build_from_dataframe(generate_synthetic_interactions(**DATA), max_seq_len=t)
    cfg = Config(model="RecBLR", config_dict=dict(CONFIG, checkpoint_dir=str(out)))
    trainer = Trainer(cfg, get_model("RecBLR")(cfg, data.n_items, t))
    sys.modules["orbax.checkpoint"] = None  # the JAX package's pickle path
    trainer.fit(data, checkpoint_path=str(out / "recblr"))
    del sys.modules["orbax.checkpoint"]
    assert trainer.ckpt_path == str(out / "recblr.pkl"), trainer.ckpt_path
    (out / "config.json").write_text(json.dumps(
        {"config": CONFIG, "data": DATA, "n_items": data.n_items, "summary": data.summary(),
         "jax": jax.__version__}, indent=1) + "\n")

    # three batches of the next epoch's order, the steps the resumed run takes
    rng = np.random.default_rng((CONFIG["seed"], 1))
    perm = rng.permutation(len(data.train))
    b = CONFIG["train_batch_size"]
    start = (trainer.best_epoch + 1) * batch_count(len(data.train), b)
    rows = perm[: RESUME_STEPS * b].reshape(RESUME_STEPS, b)
    batches = {"item_seq": data.train.item_seq[rows],
               "item_seq_len": data.train.item_seq_len[rows],
               "pos_item": data.train.pos_item[rows],
               "weight": np.ones((RESUME_STEPS, b), np.float32),
               "steps": np.arange(start, start + RESUME_STEPS, dtype=np.int64)}
    np.savez_compressed(out / "expected.npz", **expected(out, batches))
    for f in sorted(out.iterdir()):
        print(f"{f.name}: {f.stat().st_size} bytes")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(HERE.parent))
    write(Path(sys.argv[1]) if len(sys.argv) > 1 else FIXTURE)
