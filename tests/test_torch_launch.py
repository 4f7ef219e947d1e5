"""The port's training launcher with ``--sharded`` under ``torchrun`` on
the CPU (gloo), as the README gives the command."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sharded_launcher_under_torchrun(tmp_path):
    """``torchrun --nproc_per_node 2 -m repro_torch.launch.train --paper
    --sharded --device cpu --wire-dtype int8``, as the README gives it (on
    a free port: ``--standalone``), trains and reports from rank 0."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train",
         "--paper", "--sharded", "--device", "cpu", "--wire-dtype", "int8",
         "--epochs", "1"], env=env, cwd=tmp_path, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "sharded SFPL: 2 rank(s)" in res.stdout, res.stdout
    assert res.stdout.count("non-IID accuracy") == 1, res.stdout
    assert "first loss" in res.stdout, res.stdout
