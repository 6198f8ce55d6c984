"""The port's multi-process launch, as tests/test_multihost.py holds the JAX
package's: ``torchrun`` starts 2 CPU ranks of ``launch.py --train`` (gloo),
which shard ``gaussian_splatting.yaml``'s camera batch for 2 steps.  Both
ranks must log the same losses, and only rank 0 may write."""

import glob
import json
import os
import re
import subprocess
import sys

import test_torch_train  # noqa: F401  (shares the CPU threads)
from test_torch_train import PORT_CONFIG, ROOT

STEPS = 2


def test_two_process_torchrun_launch(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = os.path.abspath(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    cmd = [
        sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
        "-m", "threestudio_3dgs_tpu_torch.launch", "--device", "cpu",
        "--config", PORT_CONFIG, "--train",
        f"trainer.max_steps={STEPS}", "trainer.val_check_interval=0",
        "data.width=32", "data.height=32", "data.batch_size=4",
        "data.n_test_views=2", "data.eval_height=32", "data.eval_width=32",
        "system.geometry.init_num_pts=128", "system.geometry.max_num=512",
        "system.geometry.capacity=512", "system.renderer.tile_size=16",
        "system.renderer.max_pairs=16384", "system.guidance_type=fake-sds-guidance",
        f"exp_root_dir={tmp_path}",
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]

    # every rank logs each step; the lines agree but for the rank and clocks
    logged = {}
    for rank, line in re.findall(r"\[trainer rank (\d)/2\] (.*)", out):
        fields = dict(kv.split("=", 1) for kv in line.split())
        for clock in ("wall_s", "step_s"):
            fields.pop(clock)
        logged.setdefault(int(rank), []).append(fields)
    assert set(logged) == {0, 1}, out[-4000:]
    assert len(logged[0]) == STEPS and logged[0] == logged[1]
    assert all("train/loss_total" in row for row in logged[0])

    # one trial directory (rank 0's timestamp), written by rank 0 alone
    runs = glob.glob(os.path.join(str(tmp_path), "*", "*"))
    assert len(runs) == 1, runs
    with open(os.path.join(runs[0], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [row["step"] for row in rows] == list(range(1, STEPS + 1))
    assert os.path.exists(os.path.join(runs[0], "ckpts", "last.ckpt.npz"))
    assert len(glob.glob(os.path.join(runs[0], "save", f"it{STEPS}-test", "*.png"))) == 2
    assert "data-parallel over 2 device(s)" in out
