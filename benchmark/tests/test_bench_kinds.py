"""The text-to-3D kinds ``sd`` and ``mvdream`` as their kind modules give
them: the weight sets' directory names and bytes at the tiny sizes, and
``mfu`` on a canned context at the cells' sizes, pinned to what the
harness gave before kind modules existed (so cached sets stay valid and
no reading moves)."""

import hashlib
import os

import pytest
import torch

from benchmark import harness, kinds, metrics, weights

import tiny

# (cell, seed) -> (the set's directory name, sha256 of its files' names and bytes)
SETS = {
    ("sd21.t2i", 0): ("tiny-sd21-base-set0-52bcb05433faf8a2", "115263aa67e49e2a"),
    ("sd21.t2i", 1): ("tiny-sd21-base-set1-891181204007b105", "73f539d9d38d8c65"),
    ("mvdream.t2i", 0): ("tiny-mvdream-sd21-4view-set0-ef9527cc004df8c3", "320bc38e650b29a0"),
    ("mvdream.t2i", 1): ("tiny-mvdream-sd21-4view-set1-afbf67677987ec35", "5fe2e08ab84f2107"),
}
# the cells' own configurations: the directory names of their sets
FULL = {
    ("sd21.t2i", 0): "sd21-base-set0-9174edd55d5f5cf8",
    ("sd21.t2i", 1): "sd21-base-set1-6f38c29f5b4194f6",
    ("mvdream.t2i", 0): "mvdream-sd21-4view-set0-b75729efc549638c",
    ("mvdream.t2i", 1): "mvdream-sd21-4view-set1-2005bbfd74d45ca0",
}
# (cell, cuDNN TF32, matmul TF32) -> mfu at a 0.2 s step
MFU = {
    ("sd21.t2i", True, False): 7.840209846495727,
    ("sd21.t2i", False, True): 7.860697374292862,
    ("mvdream.t2i", True, False): 7.592603057723899,
    ("mvdream.t2i", False, True): 22.99499561757579,
}
BATCH = {"sd21.t2i": (4, 512, 512), "mvdream.t2i": (4, 256, 256)}


def files_digest(path) -> str:
    h = hashlib.sha256()
    for root, dirs, files in sorted(os.walk(path)):
        dirs.sort()
        for name in sorted(files):
            h.update(os.path.relpath(os.path.join(root, name), path).encode())
            with open(os.path.join(root, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("cell,seed", sorted(SETS))
def test_weight_sets_keep_names_and_bytes(tmp_path, cell, seed):
    c = tiny.cell(cell)
    files = kinds.load(c).weight_files(c["config"])
    path, _ = weights.ensure(str(tmp_path), c["config"], seed, torch.device("cpu"), files)
    assert (os.path.basename(path), files_digest(path)) == SETS[(cell, seed)]
    full = harness.load_cell(cell)
    name = weights.weight_dir("", full["config"], seed, kinds.load(full).weight_files(full["config"]))
    assert os.path.basename(name) == FULL[(cell, seed)]


@pytest.mark.parametrize("cell,cudnn,matmul", sorted(MFU))
def test_mfu_pinned(cell, cudnn, matmul):
    ctx = {"cell": harness.load_cell(cell), "flags": {"cudnn_tf32": cudnn, "matmul_tf32": matmul},
           "batch_shape": BATCH[cell], "step_s_untraced": 0.2}
    assert metrics.reader("mfu")(ctx) == MFU[(cell, cudnn, matmul)]
