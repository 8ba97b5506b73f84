"""Data-parallel fine-tuning steps of the port's ``DiffusionTrainer`` over
``ranks`` processes, one a card (NCCL; gloo on the CPU), as
``apps.train_diffusion`` runs under torchrun: every rank builds the engine
from the same seed, the trainer broadcasts rank 0's parameters, each rank
keeps its ``shard_batch`` slice of the global batch and averages the
gradients and the loss with one flat all_reduce a step
(``trainer.all_reduce``).

The run's own process is rank 0; it starts ranks 1 .. ranks - 1 as this
file run as a script (``--worker``), at the same cell, seed and sizes,
and joins them in ``release``.  Before each step rank 0 broadcasts a
command (step or stop), so the workers take every step that rank 0
takes: the set-up's checked steps, the window's, the traced ones and the
one after the window.  Step i's global batch (``videos`` a rank, so
``videos x ranks`` in all) and its draws come from (seed, i) on every rank
(``entries/train.py``'s ``batch``).

What is timed, traced and checked is rank 0's: ``train_step_ms`` its
window, the trace its steps, and ``check`` (``entries/train.py``'s) holds
its state against the reference stepping on the whole global batch, whose
loss and gradients are the mean over the videos, as the ranks' mean
all-reduce of their own means gives them.  ``work`` is one rank's rows.
``release`` prints each rank's peak memory (the result line's
``peak_gib`` is rank 0's).
"""

from __future__ import annotations

import argparse
import atexit
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:       # run as a worker script
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.bench import manifest  # noqa: E402

_train = manifest.load_module(Path(__file__).with_name("train.py"), "train")

STEP, STOP = 1, 0
TIMEOUT_S = 900.0       # a collective that waits longer fails its rank
JOIN_S = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_device(device, rank: int) -> torch.device:
    dev = torch.device(device)
    return torch.device("cuda", rank) if dev.type == "cuda" else dev


def _exit_with_parent(parent: int) -> None:
    """A worker ends when rank 0's process has gone (it may be blocked in a
    collective that would otherwise wait out ``TIMEOUT_S``)."""
    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(3)

    threading.Thread(target=watch, daemon=True).start()


class Entry(_train.Entry):
    unit = "step"

    def __init__(self, cell, seed: int, device, rank: int = 0, port: int = None):
        from v3d_tpu_torch.engines.trainer import DiffusionTrainer, TrainConfig
        from v3d_tpu_torch.parallel.mesh import init_distributed, make_mesh

        params = cell.traffic["params"]
        self.ranks, self.rank = params["ranks"], rank
        self.cfg, self.seed = cell.config, seed
        self.dev = _rank_device(device, rank)
        # the global batch: each rank's ``videos`` times the ranks
        self.p = dict(params, videos=params["videos"] * self.ranks)
        self.mod = cell.config_module
        self.workers = []
        if rank == 0:
            port = _free_port()
            if self.dev.type == "cuda":
                from v3d_tpu_torch.kernels.build import library

                library()               # built once, before the workers look for it
            self._start_workers(cell, seed, device, port)
        init_distributed(str(self.dev), timeout_s=TIMEOUT_S,
                         init_method=f"tcp://localhost:{port}", rank=rank,
                         world_size=self.ranks)
        self.mesh = make_mesh(data=self.ranks, model=1, device=self.dev.type)
        tc = self.cfg["train"]
        engine = self.mod.build_port(self.cfg, "train", self.dev, seed)
        self.trainer = DiffusionTrainer(
            engine, TrainConfig(base_learning_rate=tc["lr"], weight_decay=tc["weight_decay"],
                                ema_decay=tc["ema_decay"], log_every=1 << 30,
                                ckpt_every=1 << 30),
            num_frames=self.cfg["num_frames"], seed=seed, mesh=self.mesh)
        self.step_i = 0
        self.losses, self.grad, self.update, self.ema = [], {}, {}, {}
        self.window = self.window_got = None

    # -- the ranks --
    def _start_workers(self, cell, seed: int, device, port: int) -> None:
        out = manifest.PKG / "out"
        out.mkdir(parents=True, exist_ok=True)
        for r in range(1, self.ranks):
            cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
                   "--cell", cell.name, "--config", json.dumps(cell.config),
                   "--traffic", json.dumps(cell.traffic), "--seed", str(seed),
                   "--device", str(torch.device(device).type), "--rank", str(r),
                   "--port", str(port)]
            log = open(out / f"{cell.name}.rank{r}.log", "w")
            self.workers.append((subprocess.Popen(cmd, stdin=subprocess.DEVNULL, stdout=log,
                                                  stderr=subprocess.STDOUT), log))
        atexit.register(self._kill_workers)
        threading.Thread(target=self._watch_workers, daemon=True).start()

    def _watch_workers(self) -> None:
        """Rank 0 ends at once when a worker fails before ``release``: its
        collectives (the rendezvous first) would otherwise wait out
        ``TIMEOUT_S``."""
        while self.workers:
            for proc, _ in list(self.workers):
                if proc.poll() not in (None, 0):
                    print(f"train_dp: a worker exited with {proc.returncode} "
                          f"(portbench/out/*.rank*.log)", file=sys.stderr, flush=True)
                    os._exit(4)
            time.sleep(1.0)

    def _kill_workers(self) -> None:
        for proc, log in self.workers:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()

    def _command(self, cmd: int = None) -> int:
        """Rank 0 sends ``cmd`` to every rank; a worker receives it."""
        import torch.distributed as dist

        t = torch.full((1,), STOP if cmd is None else cmd, dtype=torch.int64, device=self.dev)
        dist.broadcast(t, src=0)
        return cmd if self.rank == 0 else int(t.item())

    def serve(self) -> None:
        """A worker's life: the steps rank 0 commands, then ``release``."""
        while self._command() == STEP:
            self._rank_step()
        self.release()

    # -- steps --
    def _rank_step(self) -> float:
        from v3d_tpu_torch.apps.train_diffusion import prepare_batch

        raw = self.batch(self.step_i)
        mine = self.trainer.shard_batch({k: v for k, v in raw.items()
                                         if k not in ("sigmas", "noise")})
        prepared = prepare_batch(self.trainer.engine, mine, self.cfg["num_frames"],
                                 mesh=self.mesh)
        stats = self.trainer.train_step(prepared["latents"], prepared["cond"],
                                        sigmas=raw["sigmas"], noise=raw["noise"])
        self.step_i += 1
        return stats["loss"]

    def _step(self) -> float:
        self._command(STEP)
        return self._rank_step()

    def work(self):
        """One rank's step: the single cell's work at a rank's videos, so
        the attention sites are those rank 0's kernels run."""
        p = self.p
        self.p = dict(p, videos=p["videos"] // self.ranks)
        try:
            return super().work()
        finally:
            self.p = p

    def release(self) -> None:
        """Stop the workers (rank 0), each rank's peak memory printed, the
        group left, the workers joined."""
        import torch.distributed as dist

        if self.rank == 0:
            self._command(STOP)
        peak = torch.cuda.max_memory_allocated(self.dev) if self.dev.type == "cuda" else 0
        peaks = [torch.zeros(1, dtype=torch.float64, device=self.dev)
                 for _ in range(self.ranks)]
        dist.all_gather(peaks, torch.full((1,), float(peak), dtype=torch.float64,
                                          device=self.dev))
        if self.rank == 0:
            print("peak GiB by rank: " + ", ".join(f"{float(p) / 2**30:.4f}" for p in peaks),
                  flush=True)
        dist.destroy_process_group()
        super().release()
        failed = []
        for proc, log in self.workers:
            try:
                rc = proc.wait(timeout=JOIN_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(rc)
        self.workers = []
        if failed:
            raise RuntimeError(f"train_dp: workers exited with {failed} "
                               f"(portbench/out/*.rank*.log)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="a worker rank of entries/train_dp.py")
    p.add_argument("--worker", action="store_true", required=True)
    p.add_argument("--cell", required=True)
    p.add_argument("--config", required=True, help="the cell's configuration, JSON")
    p.add_argument("--traffic", required=True, help="the cell's traffic, JSON")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    args = p.parse_args(argv)
    _exit_with_parent(os.getppid())
    cell = manifest.load_cell(args.cell)
    cell.config, cell.traffic = json.loads(args.config), json.loads(args.traffic)
    if args.device == "cpu":      # the CPU's cores shared by the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // cell.traffic["params"]["ranks"]))
    Entry(cell, args.seed, args.device, rank=args.rank, port=args.port).serve()
    return 0


if __name__ == "__main__":
    sys.exit(main())
