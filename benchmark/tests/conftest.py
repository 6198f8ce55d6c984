"""Settings of the benchmark's own tests (run with
``python -m pytest benchmark/tests``): the ``gpu`` marker of the tests
that need a CUDA device, and few CPU threads per process."""

import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")
    torch.set_num_threads(max(1, min(4, torch.get_num_threads())))
