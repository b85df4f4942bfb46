"""Data-parallel packed training of a flow system (the flagship MMF) on
one node: `ranks` processes, one a card, `Trainer` over the data mesh
(`Trainer._average_gradients`: one flattened all-reduce of the gradients
a step).  Every rank holds the resident set and each global batch, and
runs the forward on its share of the rows, so a step is the one-card step
on the whole batch.

Traffic parameters: those of `packed_training.py`, `jets_per_step`
counting the global batch (all ranks together), and `ranks` (this process
is rank 0 on the run's device; the others are spawned here, rank r on
card r, or on the CPU over gloo for a CPU run), `warm_seconds` (steps on
every rank after the check's first steps and before the first window,
part of the set-up: a fresh machine's first minutes run slower) and
`group_timeout_s` (the process group's timeout: a rank that fails ends
the run with an error within it).

Every window runs a number of steps fixed before it, from the pace of the
last warm round; rank 0 sends it to the others, which run the same steps
from the same batch stream.  The work records are rank 0's: its rows of
each step, so the per-layer readers read one card's share;
`trained_jets_per_s` counts every rank's jets.  At release rank 0 sends
every other rank its stop first, then all ranks tear the process group
down together: NCCL's teardown waits for every rank of the group, so a
rank that tears down while the others still wait for steps never returns.

The check: `packed_training.py`'s, on the global batch.  The reference
repeats the first steps over every rank's rows, against the global loss
(the ranks' losses averaged), the first clipped gradient from Adam's first
moment (the ranks' mean gradient) and the parameters' change, as rank 0
recorded them.
"""

from __future__ import annotations

import datetime
import socket
import time
import traceback
from typing import Dict, List

import torch

from bench_torch import jets
from bench_torch.drivers import packed_training
from bench_torch.drivers.common import CHECK_STEPS, synchronize
from bench_torch.reference import packing

#: the steps of the first warm round, and the seconds of each later one
FIRST_ROUND_STEPS = 10
WARM_ROUND_S = 5.0
#: seconds rank 0 waits for each other rank to end after the group is down
JOIN_S = 60.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, port: int, spec: Dict, commands, errors) -> None:
    """Rank `rank` (> 0): the common set-up, then the steps rank 0 sends,
    until it sends none."""
    try:
        from bench_torch.harness import Run

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_num_threads(1)
        device = (torch.device("cuda", rank) if spec["device"] == "cuda"
                  else torch.device("cpu"))
        run = Run(spec["cell"], spec["cfg"], spec["traffic"], spec["seed"], device, False)
        driver = Driver(run, rank)
        driver.setup_rank(port)
        while True:
            n = commands.get()
            if n is None:
                break
            for _ in range(n):
                driver._step()
        # the stop: rank 0 tears the group down now too
        synchronize(device)
        torch.distributed.destroy_process_group()
    except BaseException:
        errors.put((rank, traceback.format_exc()))
        raise


class Driver(packed_training.Driver):

    def __init__(self, run, rank: int = 0):
        super().__init__(run)
        self.rank = rank
        self.world = int(run.traffic["ranks"])
        self.step_s = None
        self._procs: List = []
        self._commands: List = []
        self._errors = None

    # ----------------------------------------------------------------- set-up

    def setup(self) -> None:
        """Rank 0: the other ranks spawned, the common set-up, the warm
        rounds."""
        run = self.run
        port = _free_port()
        ctx = torch.multiprocessing.get_context("spawn")
        self._errors = ctx.SimpleQueue()
        spec = dict(cell=run.cell, cfg=run.cfg, traffic=run.traffic, seed=run.seed,
                    device=run.device.type)
        for r in range(1, self.world):
            commands = ctx.SimpleQueue()
            proc = ctx.Process(target=_rank_main, args=(r, port, spec, commands, self._errors),
                               daemon=True)
            proc.start()
            self._procs.append(proc)
            self._commands.append(commands)
        self.setup_rank(port)
        self._warm()

    def setup_rank(self, port: int) -> None:
        """Every rank: the process group, the system from rank 0's weights
        on the data mesh, the data, and the check's first CHECK_STEPS steps
        (`TrainDriver.setup` on the mesh, the loss averaged over the ranks)."""
        from multimodal_flows_tpu_torch.data.datasets import num_batches
        from multimodal_flows_tpu_torch.train.trainer import Trainer

        run, t = self.run, self.run.traffic
        cuda = run.device.type == "cuda"
        if cuda:
            torch.cuda.set_device(run.device)
        torch.distributed.init_process_group(
            "nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}",
            world_size=self.world, rank=self.rank,
            timeout=datetime.timedelta(seconds=t["group_timeout_s"]),
            **({"device_id": run.device} if cuda else {}))
        self.system, self.train_cfg, ds = self.build()
        self.system.module.load_state_dict(run.params, strict=True)
        for v in self.system.module.state_dict().values():
            torch.distributed.broadcast(v, 0)
        self.trainer = Trainer(self.system, self.train_cfg)   # the data mesh of the group
        self.units, self.rows_per_step = self.split(ds)
        self.data = [self.trainer._resident(u) for u in self.units]
        spe = sum(num_batches(len(u), self.rows_per_step) for u in self.units)
        self.state = self.trainer.init_state(spe)
        self.perm_seed = jets.sub_seed(run.seed, 2)
        self._stream = self._batches()
        self._pending = []

        module, opt = self.state.module, self.state.optimizer
        p0 = {n: p.detach().clone() for n, p in module.named_parameters()}
        losses = []
        for i in range(CHECK_STEPS):
            out, _ = self._step()
            loss = out["loss"].detach().clone()
            torch.distributed.all_reduce(loss)
            losses.append(loss / self.world)
            if i == 0:
                beta1 = opt.param_groups[0]["betas"][0]
                g1 = {n: opt.state[p].get("exp_avg", torch.zeros_like(p)).detach().clone()
                      / (1.0 - beta1) for n, p in module.named_parameters()}
        self.first = {"losses": [float(v) for v in losses], "grad": g1,
                      "delta": {n: p.detach() - p0[n] for n, p in module.named_parameters()}}
        synchronize(run.device)

    def _warm(self) -> None:
        """Rounds of steps on every rank until `warm_seconds` have passed;
        the last round's pace sets each window's steps.  Each round's
        jets a second (every rank's) are kept as a note."""
        t0 = time.perf_counter()
        n = FIRST_ROUND_STEPS
        rates = []
        while True:
            r0 = time.perf_counter()
            done = self._steps(n)
            synchronize(self.run.device)
            wall = time.perf_counter() - r0
            self.step_s = wall / n
            rates.append(round(done / wall, 1))
            if time.perf_counter() - t0 >= self.run.traffic["warm_seconds"]:
                break
            n = max(1, round(WARM_ROUND_S / self.step_s))
        self.notes = {"warm_rounds_jets_per_s": rates}

    def _send(self, n) -> None:
        """`n` steps (None: stop) to every other rank, which must all be up."""
        if not self._errors.empty():
            rank, err = self._errors.get()
            raise RuntimeError(f"rank {rank} failed:\n{err}")
        dead = [r + 1 for r, p in enumerate(self._procs) if not p.is_alive()]
        if dead:
            raise RuntimeError(f"rank(s) {dead} ended early")
        for commands in self._commands:
            commands.put(n)

    def _steps(self, n: int) -> int:
        """`n` steps on every rank; returns the jets of all ranks."""
        self._send(n)
        return sum(self.row_work(*self._step()[1])["jets"] for _ in range(n))

    # ----------------------------------------------------------------- window

    def window(self, seconds: float) -> None:
        """`TrainDriver.window` with the step count fixed before it."""
        device = self.run.device
        on_cuda = device.type == "cuda"
        n = max(1, round(seconds / self.step_s))
        self._send(n)
        events = []
        if on_cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        self.attempted = self.failed = 0
        self.window_steps = []
        t0 = time.perf_counter()
        for _ in range(n):
            _, where = self._step()
            self.window_steps.append(where)
            if on_cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        synchronize(device)
        self.wall = time.perf_counter() - t0
        self.gaps_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]

    def traced_work(self) -> List[Dict]:
        """Rank 0's rows of each step (`parallel/mesh.py:data_rows`: the
        first of `ranks` equal shares)."""
        return [self.row_work(ui, rows[:len(rows) // self.world])["record"]
                for ui, rows in self.window_steps]

    def release(self) -> None:
        """The stop to every other rank first, then every rank tears the
        group down together, then rank 0 waits for the others to end."""
        synchronize(self.run.device)
        self._send(None)
        torch.distributed.destroy_process_group()
        for proc in self._procs:
            proc.join(JOIN_S)
            if proc.is_alive():
                proc.kill()
        super().release()

    # ------------------------------------------------------------------ check

    def _layout(self):
        """`packed_training.Driver._layout` with the trainer's row batch
        over the mesh: a whole number of rows a rank."""
        if not hasattr(self, "_lay"):
            t = self.run.traffic
            W = t["pack_width"]
            row_of, offset_of, n_rows = packing.pack_jets(self.mult, W)
            if (row_of < 0).any():
                raise ValueError("the reference packs jets of at most pack_width particles")
            slot = packing.segment_slots(row_of, offset_of)
            bs = packing.training_row_batch(len(self.mult), n_rows, t["jets_per_step"])
            bs = min(max(bs // self.world * self.world, self.world), t["jets_per_step"])
            total = packing.padded_rows(n_rows, bs)
            perm = packing.epoch_perm(total, bs, self.perm_seed, 0)
            self._lay = dict(row_of=row_of, offset_of=offset_of, slot=slot, bs=bs,
                             n_slots=int(slot.max()) + 1, perm=perm, W=W)
        return self._lay
