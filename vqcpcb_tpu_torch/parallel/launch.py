"""Run a function on the ranks of a local process group, one process per
rank, with a deadline.

    results = run_ranks("package.module:function", 4, payload, timeout_s=120)

Each rank is `python -m vqcpcb_tpu_torch.parallel.launch <spec>`: it joins
the group through distributed.maybe_initialize's coordinator path
(VQCPCB_COORDINATOR=127.0.0.1:<a port the OS gave>, VQCPCB_NUM_PROCESSES,
VQCPCB_PROCESS_ID), with the group's timeout, calls target(rank,
world_size, payload) and saves what it returns. The parent waits for all until the deadline; a rank that fails or
outlives it gets every rank killed, and the parent raises with the ends of
their error output. The payload and the results are pickled by this module
and read back only by it.
"""
from __future__ import annotations

import datetime
import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, List

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port of 127.0.0.1 the OS had free."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(target: str, world_size: int, payload: Any = None, *,
              timeout_s: float, backend: str = "gloo", threads: int = 1
              ) -> List[Any]:
    """target(rank, world_size, payload) on `world_size` rank processes
    ("module:function", importable from the checkout's root); returns their
    results in rank order. threads: torch's CPU threads per rank."""
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="ranks_") as work:
        procs, logs = [], []
        run_env = dict(os.environ)
        run_env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in run_env.get("PYTHONPATH", "").split(os.pathsep) if p])
        # the ranks start from the coordinator variables alone
        for name in ("VQCPCB_DISTRIBUTED", "MASTER_ADDR", "MASTER_PORT",
                     "WORLD_SIZE", "RANK", "LOCAL_RANK"):
            run_env.pop(name, None)
        run_env.update(VQCPCB_COORDINATOR=f"127.0.0.1:{port}",
                       VQCPCB_NUM_PROCESSES=str(world_size))
        try:
            for rank in range(world_size):
                spec = os.path.join(work, f"spec_{rank}.pkl")
                with open(spec, "wb") as f:
                    pickle.dump(dict(target=target, rank=rank, world_size=world_size,
                                     backend=backend, timeout_s=timeout_s,
                                     threads=threads, payload=payload,
                                     result=os.path.join(work, f"result_{rank}.pkl")),
                                f)
                log = open(os.path.join(work, f"log_{rank}.txt"), "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "vqcpcb_tpu_torch.parallel.launch", spec],
                    cwd=REPO, env=dict(run_env, VQCPCB_PROCESS_ID=str(rank)),
                    stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout_s
            while any(p.poll() is None for p in procs):
                failed = [p for p in procs if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            codes = [p.poll() for p in procs]
            if any(c != 0 for c in codes):
                tails = []
                for rank, log in enumerate(logs):
                    log.seek(0)
                    tails.append(f"--- rank {rank} (exit {codes[rank]}) ---\n"
                                 + log.read()[-3000:])
                reason = ("failed" if any(c not in (None, 0) for c in codes)
                          else "outlived the deadline")
                raise RuntimeError(f"{target} on {world_size} ranks {reason} "
                                   f"(exit codes {codes})\n" + "\n".join(tails))
            results = []
            for rank in range(world_size):
                with open(os.path.join(work, f"result_{rank}.pkl"), "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.close()


def _rank_main(spec_path: str) -> None:
    import torch.distributed as dist

    from vqcpcb_tpu_torch.parallel import distributed
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(spec["threads"])
    module, name = spec["target"].split(":")
    fn = getattr(importlib.import_module(module), name)
    # the device picks the backend: a gloo rank joins as a CPU rank (gloo
    # ranks may share one card), an NCCL rank takes cuda:LOCAL_RANK (here
    # its process id modulo the host's GPUs)
    if not distributed.maybe_initialize(
            "cpu" if spec["backend"] == "gloo" else None,
            timeout=datetime.timedelta(seconds=spec["timeout_s"])):
        raise RuntimeError("maybe_initialize found no VQCPCB_COORDINATOR")
    try:
        result = fn(spec["rank"], spec["world_size"], spec["payload"])
    finally:
        dist.destroy_process_group()
    with open(spec["result"], "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    _rank_main(sys.argv[1])
