"""Imported by the port's test files for its side effect: one intra-op
thread pool per xdist worker, sized to its share of the cores, so the
workers' torch threads do not oversubscribe the machine."""
import os

import torch

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
