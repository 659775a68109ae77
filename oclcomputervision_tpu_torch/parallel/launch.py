"""Start an n-rank ``torch.distributed`` process group on this machine and
run one function on every rank.

    python -m oclcomputervision_tpu_torch.parallel.launch --nproc 4 \
        [--backend gloo|nccl] [--device cuda|cpu] TARGET [ARG ...]

TARGET is ``package.module:function`` or ``path/to/file.py:function``. Every
rank calls ``function(device, *ARG)`` (the ARGs as strings) once its process
group is up: ``init_method="file://..."`` in a new temporary directory (no
network), the backend given, and the device: by default 'cuda', the CUDA
device rank % device_count, made current (the launcher raises if torch sees
no card); 'cpu' only when asked for. NCCL takes one rank per card; several
ranks on one card need gloo, whose collectives the port stages through host
memory.

The ranks are spawned with ``torch.multiprocessing`` from this module's
``__main__``, so whatever process starts the launcher (a test runner, a
script) is never re-imported by them. A rank that raises fails the run: the
other ranks are stopped, and the launcher exits non-zero with that rank's
traceback. ``spawn`` runs the launcher in a child process of its own.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import importlib.util
import os
import signal
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from oclcomputervision_tpu_torch._device import as_device

RENDEZVOUS_TIMEOUT_S = 300
# the directory that holds the package, which the launcher's child must import
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _resolve(target: str):
    """The function that ``module:function`` or ``file.py:function`` names."""
    where, _, name = target.rpartition(":")
    if not where or not name:
        raise ValueError(f"target {target!r} is not module:function or file.py:function")
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            os.path.splitext(os.path.basename(where))[0], where
        )
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _rank_main(rank: int, nproc: int, backend: str, device: str, init_file: str, target: str,
               args: tuple) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nproc))
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=nproc, rank=rank,
        timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S),
    )
    try:
        _resolve(target)(dev, *args)
    finally:
        dist.destroy_process_group()


def run(nproc: int, target: str, args=(), backend: str = "gloo", device: str = "cuda") -> None:
    """Run ``target`` on ``nproc`` spawned ranks and wait for all of them;
    raises if any rank fails, or if the device is the card and torch sees
    none."""
    if nproc < 1:
        raise ValueError(f"nproc must be >= 1, got {nproc}")
    device = str(as_device(device))
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            _rank_main,
            args=(nproc, backend, device, os.path.join(tmp, "rendezvous"), target, tuple(args)),
            nprocs=nproc, join=True, start_method="spawn",
        )


def spawn(nproc: int, target: str, args=(), backend: str = "gloo", device: str = "cuda",
          timeout: float | None = None, capture: bool = False) -> str | None:
    """Run the launcher (``run``) in a child process in a session of its own,
    with the package on its path, and wait for it. On a timeout, or if the
    waiting is interrupted, the whole session (launcher and ranks) is
    killed and the exception raised; a non-zero exit raises RuntimeError.
    With ``capture`` the child's output is returned (and ends the error's
    message), else it goes to this process's own."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "oclcomputervision_tpu_torch.parallel.launch",
           "--nproc", str(nproc), "--backend", backend, "--device", str(device), target,
           *(str(a) for a in args)]
    pipe = subprocess.PIPE if capture else None
    proc = subprocess.Popen(cmd, env=env, start_new_session=True, text=True, stdout=pipe,
                            stderr=subprocess.STDOUT if capture else None)
    try:
        log, _ = proc.communicate(timeout=timeout)
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    if proc.returncode:
        raise RuntimeError(f"{nproc} {backend} rank(s) of {target} failed (exit "
                           f"{proc.returncode})" + (f":\n{log}" if capture else ""))
    return log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, required=True, help="ranks to start")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    ap.add_argument("target", help="module:function or file.py:function")
    ap.add_argument("args", nargs="*", help="passed to the function as strings")
    a = ap.parse_args(argv)
    run(a.nproc, a.target, a.args, a.backend, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
