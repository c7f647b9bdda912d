"""The ranks of a run: ``One`` for a cell on one device, ``Ranks`` for a cell
whose configuration has a ``parallel`` block (``{"ranks": n}``, n the
cell's ``chips``), which runs one rank a card through the program's
``parallel/mesh.py``. ``run.run_cell`` drives either through the same four
calls: ``more`` (whether another step of the window runs), ``gather`` (each
rank's numbers on rank 0), ``close``, and the ``mesh`` it hands the loop.

The process that ``rtbench/run.py`` starts is rank 0. ``Ranks`` there loads
the program's CUDA kernels first (so that no two processes build into
``csrc/build/`` at once), starts ranks 1..n-1 as worker processes on a free
local TCP port (``python -m rtbench.shard <job>``, each running the same
``run.run_cell`` as its rank), and every rank joins through
``mesh.init_distributed`` (its default backend: NCCL, rank k on ``cuda:k``;
gloo on the CPU) with a gloo group beside it on the host. The loop is the fit
of ``rtbench/workload.py`` given the mesh: ``mesh.make_sharded_train_step``,
each rank one pixel tile of ``mesh.make_mesh`` (2x2 for 4 ranks), the
reduced gradients and so the parameters alike on every rank. Before each
step of the window rank 0 says over the gloo group whether another one
runs, so the window is rank 0's clock and adds no sync of the card. After the window and the traced stretch
(which every rank profiles alike) each worker sends rank 0 its peak memory,
its host CPU time over the window and the rays of its stretch, leaves the
group and exits; only rank 0 checks and prints.

A worker that exits with an error ends the run: rank 0's watcher kills the
other workers and, where rank 0's main thread stays held in a collective,
ends the process after ``GRACE`` seconds. ``TIMEOUT`` bounds every collective
and the rendezvous, so a rank that stalls fails the run too; a worker dies
with rank 0.
"""
from __future__ import annotations

import ctypes
import datetime
import json
import os
import signal
import socket
import subprocess
import sys
import threading

import torch
import torch.distributed as dist

from rtbench import manifest

TIMEOUT = datetime.timedelta(seconds=60)   # every collective and the rendezvous
POLL = 0.5          # s between the watcher's looks at the workers
GRACE = 20.0        # s rank 0 has to end after a worker failed, before it is ended
JOIN = 60.0         # s a worker has to exit once it has sent its numbers
FAILED = 4          # rank 0's exit code where the watcher ends it
LEVEL_PREFIX = "rt.p.level."


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_argv(job: dict) -> list:
    """The command that starts a worker rank."""
    return [sys.executable, "-m", "rtbench.shard", json.dumps(job)]


def die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when rank 0's process ends (Linux)."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)           # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:                  # rank 0 ended before the call
        os._exit(FAILED)


def ranks(config: dict, cell: dict, job: dict, rank: int = 0,
          coordinator: str | None = None):
    """This process's ranks: ``Ranks`` where the configuration has a
    ``parallel`` block, else ``One`` on ``job``'s device."""
    if "parallel" not in config:
        return One(job["device"])
    n = config["parallel"]["ranks"]
    if n != cell["chips"]:
        raise ValueError(f"the configuration's {n} ranks are not the cell's {cell['chips']} chips")
    return Ranks(n, job, rank, coordinator)


def log_rays(mark: int) -> float:
    """The rays of the program's wavefront levels logged after entry ``mark``
    of its counter log (``utils/profiling.py::RECORDER``): the levels of the
    spans recorded since."""
    from realtrace_tpu_torch.utils.profiling import RECORDER

    return float(sum(c["rays"] for name, c in list(RECORDER.log)[mark:]
                     if name.startswith(LEVEL_PREFIX)))


def log_mark() -> int:
    """The counter log's length (it grows only while a profiler records)."""
    from realtrace_tpu_torch.utils.profiling import RECORDER

    return len(RECORDER.log)


class One:
    """A run on one device: the window is this process's clock alone."""

    rank, world, mesh = 0, 1, None

    def __init__(self, device):
        self.device = device
        self.mark = log_mark()

    def more(self, go: bool) -> bool:
        return go

    def gather(self, numbers: dict) -> list:
        return [numbers]

    def close(self, ok: bool = True) -> None:
        pass


class Ranks:
    """This process's place among the ranks (see module doc): ``rank``,
    ``world``, its ``device``, the gloo group ``host``; on rank 0 the
    workers and their watcher. ``job`` is what a worker needs to run the
    cell as rank 0 does: its name, seed, ``traced``, device and overrides."""

    def __init__(self, world: int, job: dict, rank: int = 0, coordinator: str | None = None):
        from realtrace_tpu_torch.parallel import mesh

        self.rank, self.world = rank, world
        cuda = torch.device(job["device"]).type == "cuda"
        # every rank's traffic is local: its rendezvous and its bootstrap on loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        self.procs, self.failed = [], None
        self._done = threading.Event()
        if rank == 0:
            if cuda:
                from realtrace_tpu_torch.ops import cuda_build
                cuda_build.load()
            coordinator = f"127.0.0.1:{free_port()}"
            for k in range(1, self.world):
                w = dict(job, rank=k, coordinator=coordinator, parent=os.getpid())
                self.procs.append(subprocess.Popen(worker_argv(w), stdout=2, cwd=manifest.ROOT))
            threading.Thread(target=self._watch, daemon=True).start()
        try:
            self.device = mesh.init_distributed(
                coordinator, self.world, rank,
                device=f"cuda:{rank}" if cuda else job["device"], timeout=TIMEOUT)
            self.host = dist.new_group(backend="gloo", timeout=TIMEOUT)
        except BaseException:
            self.close(ok=False)
            raise
        self.mesh = mesh.make_mesh(self.world)
        self.mark = log_mark()

    def _watch(self) -> None:
        """Rank 0: end the run when a worker exits with an error."""
        while not self._done.wait(POLL):
            rcs = [p.poll() for p in self.procs]
            bad = [(k + 1, rc) for k, rc in enumerate(rcs) if rc not in (None, 0)]
            if not bad:
                continue
            self.failed = f"rank {bad[0][0]} exited with code {bad[0][1]}"
            print(f"rtbench: {self.failed}; ending the run", file=sys.stderr, flush=True)
            self._kill()
            if not self._done.wait(GRACE):
                print("rtbench: rank 0 is held in a collective; exiting", file=sys.stderr,
                      flush=True)
                os._exit(FAILED)
            return

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def more(self, go: bool) -> bool:
        """Whether the ranks run another step: rank 0's ``go``, on every rank."""
        t = torch.tensor([int(go)], dtype=torch.int32)
        dist.broadcast(t, 0, group=self.host)
        return bool(t.item())

    def gather(self, numbers: dict) -> list | None:
        """Each rank's ``numbers`` on rank 0, in rank order; None elsewhere."""
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(numbers, out, dst=0, group=self.host)
        return out

    def close(self, ok: bool = True) -> None:
        """Leave the group; on rank 0 wait for the workers (killed where the
        run failed or one does not exit in ``JOIN`` seconds). Raises where a
        worker failed."""
        try:
            if not ok:
                self._kill()
            if dist.is_initialized():
                dist.destroy_process_group()
            for p in self.procs:
                try:
                    p.wait(timeout=JOIN)
                except subprocess.TimeoutExpired:
                    self._kill()
        finally:
            self._done.set()
        rcs = [p.returncode for p in self.procs]
        if ok and any(rcs):
            raise RuntimeError(self.failed or f"the worker ranks exited with codes {rcs}")


def main() -> int:
    """A worker rank: ``run.run_cell`` with the job rank 0 gave it (the
    first argument)."""
    job = json.loads(sys.argv[1])
    die_with_parent(job["parent"])
    from rtbench import run

    run.run_cell(job["cell"], job["seed"], 0.0, job["traced"], device=job["device"],
                 config_overrides=job["config_overrides"],
                 traffic_overrides=job["traffic_overrides"], rank=job["rank"],
                 coordinator=job["coordinator"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
