"""Start N local ranks of the train CLI joined into one process group
(counterpart of scripts/launch_local.py, the reference's Lightning
`ddp_spawn`).

    python -m gennerf_tpu_torch.tools.launch_local -n 2 -- \\
        --config configs/experiment/seqs_multigeo_4cm.yaml --out runs/dp --data-dir D \\
        trainer.devices=2 [--device cpu]

Each child runs `python -m gennerf_tpu_torch.train <arguments>` with
GENNERF_COORDINATOR (localhost:<free port>), GENNERF_NUM_PROCESSES and
GENNERF_PROCESS_ID, which parallel.distributed.init_distributed reads;
rank r drives cuda:r (or the CPU under --device cpu). Child 0's output
streams through, the others' go to --log-dir/rank<r>.log when given (else
they are dropped); when a child fails the launcher stops the others and
exits with its code. SIGTERM
and SIGINT are passed on to every child.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="local multi-rank launcher of the train CLI")
    parser.add_argument("-n", "--num-processes", type=int, default=2)
    parser.add_argument("--log-dir", help="write ranks 1.. output to <dir>/rank<r>.log")
    parser.add_argument("args", nargs=argparse.REMAINDER,
                        help="arguments of the train CLI (after --)")
    ns = parser.parse_args(argv)
    child_args = list(ns.args)
    if child_args[:1] == ["--"]:
        child_args = child_args[1:]
    coordinator = f"localhost:{free_port()}"
    procs, logs = [], []
    for rank in range(ns.num_processes):
        env = dict(os.environ)
        env.update(GENNERF_COORDINATOR=coordinator,
                   GENNERF_NUM_PROCESSES=str(ns.num_processes),
                   GENNERF_PROCESS_ID=str(rank))
        out = None
        if rank:
            if ns.log_dir:
                os.makedirs(ns.log_dir, exist_ok=True)
                out = open(os.path.join(ns.log_dir, f"rank{rank}.log"), "w")
                logs.append(out)
            else:
                out = subprocess.DEVNULL
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gennerf_tpu_torch.train", *child_args], env=env,
            stdout=out, stderr=subprocess.STDOUT if rank else None))

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    previous = {s: signal.signal(s, forward) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        failed = None
        while any(p.poll() is None for p in procs):
            failed = failed or next((p for p in procs if p.poll()), None)
            if failed is not None:  # the others would wait at a collective
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            time.sleep(0.2)
        return next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for s, h in previous.items():
            signal.signal(s, h)
        for f in logs:
            f.close()


if __name__ == "__main__":
    sys.exit(main())
