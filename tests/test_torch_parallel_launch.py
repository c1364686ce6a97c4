"""A meshed experiment as a user launches it: ``python -m
torch.distributed.run --nproc-per-node 2 -m datamining_recblr_torch.run``
with ``mesh_shape {data: 1, model: 2}`` and ``multihost``, two CPU ranks
over gloo, on a small stat-matched dataset.  Both ranks train, test and
print the same metrics, and the training-curve CSV is written."""

import os
import socket
import subprocess
import sys
from pathlib import Path

from datamining_recblr_torch.data.synthetic import write_stat_matched_dataset

ROOT = Path(__file__).resolve().parents[1]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_torch_distributed_run_trains_on_two_cpu_ranks(tmp_path):
    write_stat_matched_dataset(str(tmp_path / "dataset"), "ml1m-synth", out_name="t",
                               n_users=40, n_items=30, n_inters=900, n_clusters=5)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
           "-m", "datamining_recblr_torch.run", "--config", "reference", "-d", "t",
           "--epochs", "1", "--device", "cpu", "--set", "hidden_size=8",
           "--set", "MAX_ITEM_LIST_LENGTH=8", "--set", "train_batch_size=64",
           "--set", "mesh_shape={'data': 1, 'model': 2}", "--set", "vocab_row_shard=always",
           "--set", "multihost=True"]
    run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=240)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    tests = [line for line in run.stdout.splitlines() if line.startswith("test:")]
    assert len(tests) == 2 and tests[0] == tests[1], run.stdout[-2000:]
    assert "ndcg@10" in tests[0]
    assert len(list((tmp_path / "plot").glob("*.csv"))) == 1


def test_torch_distributed_run_trains_seq_parallel_on_two_cpu_ranks(tmp_path):
    """The same launch with RecBLR's time axis over ``{data: 1, seq: 2}``:
    both ranks train, test and print the same metrics."""
    write_stat_matched_dataset(str(tmp_path / "dataset"), "ml1m-synth", out_name="t",
                               n_users=40, n_items=30, n_inters=900, n_clusters=5)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
           "-m", "datamining_recblr_torch.run", "--config", "reference", "-d", "t",
           "--epochs", "1", "--device", "cpu", "--set", "hidden_size=8",
           "--set", "MAX_ITEM_LIST_LENGTH=8", "--set", "train_batch_size=64",
           "--set", "mesh_shape={'data': 1, 'seq': 2}", "--set", "multihost=True"]
    run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=240)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    tests = [line for line in run.stdout.splitlines() if line.startswith("test:")]
    assert len(tests) == 2 and tests[0] == tests[1], run.stdout[-2000:]
    assert "ndcg@10" in tests[0]
