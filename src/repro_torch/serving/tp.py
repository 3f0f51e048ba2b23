"""Tensor-parallel ranks of one paged backend (DESIGN.md §8), the
counterpart of the reference's ``shard_map`` over a ('model',) mesh.

The reference runs one program over N devices from one controller.  Here
each rank is a process: rank 0 is the caller's (it holds the
``ServeEngine``), ranks 1..N-1 are workers started with the "spawn" method
(never fork after CUDA is up).  Every rank builds the same backend on its
shard of the weights and of the page pool; rank 0 sends each device call
(a backend method's name and its host-side arguments) to the workers, then
runs it itself, and the collectives inside the forward keep the ranks in
step.  The engine, the streams and every host-side table stay on rank 0.

Channels:

- control: a pipe to each worker.  A worker waits for its next call as
  long as rank 0 is idle, and reads end-of-file when rank 0 goes away,
  which ends it; replies (an export's pages, the ranks' stats) come back
  the same way.
- data: the activations' collectives, chosen by a rule on the ranks'
  devices (``data_kind``).  Ranks on one host's CPUs, or sharing ONE CUDA
  device, exchange through buffers shared between the processes (shared
  memory, or CUDA IPC on the card) and a barrier in shared host memory;
  every rank sums the ranks' pieces in rank order, so every rank holds the
  same bits.  Ranks with a CUDA device each use NCCL (NCCL refuses two
  ranks on one device).

A dead worker makes rank 0 raise, never hang: a call to it fails on its
closed pipe, a collective fails within ``timeout`` seconds (the shared
barrier at once, when it sees the process gone), and a reply not sent
within ``timeout`` raises.  ``close`` stops and joins the workers and
raises if one did not exit cleanly; the backend also runs it from a
``weakref.finalize``.

Each worker imports the caller's main module (the "spawn" method does), so
a script that builds a tp > 1 backend guards its entry with ``if __name__
== "__main__":``.
"""

from __future__ import annotations

import datetime
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import List, Sequence

import torch

TIMEOUT = 60.0      # seconds: collectives, replies, the rendezvous
SHARED_BYTES = 4 << 20   # per rank and parity; longer messages go in pieces


def data_kind(devices: Sequence[torch.device]) -> str:
    """The data group's transport for ranks on ``devices`` (one per rank):
    "shared" for ranks on the CPU or sharing one CUDA device, "nccl" for
    ranks with a CUDA device each."""
    types = {d.type for d in devices}
    if types == {"cpu"}:
        return "shared"
    if types != {"cuda"}:
        raise ValueError(f"tensor-parallel ranks on {list(devices)}: all "
                         "CPUs or all CUDA devices")
    if len(set(devices)) == len(devices):
        return "nccl"
    if len(set(devices)) == 1:
        return "shared"
    raise ValueError(f"tensor-parallel ranks on {list(devices)}: one CUDA "
                     "device each, or one shared by every rank")


class _Counted:
    """A rank's data group: ``n`` counts its collectives and ``seconds``
    the host time spent in them (waits for the device and for the other
    ranks included; NCCL's are only queued on the stream)."""
    kind = ""

    def __init__(self, rank: int, size: int, device: torch.device):
        self.rank, self.size, self.device = rank, size, device
        self.n = 0
        self.seconds = 0.0

    def all_reduce(self, x):
        """The sum of every rank's ``x``."""
        t0 = time.perf_counter()
        out = self._all_reduce(x)
        self.n += 1
        self.seconds += time.perf_counter() - t0
        return out

    def all_gather(self, x):
        """Every rank's ``x``, joined on the last dim in rank order."""
        t0 = time.perf_counter()
        out = self._all_gather(x)
        self.n += 1
        self.seconds += time.perf_counter() - t0
        return out

    def release(self) -> None:
        """Drop what the group shares with the other ranks."""


class NcclData(_Counted):
    """Collectives of a ``ProcessGroupNCCL``, through its own methods."""
    kind = "nccl"

    def __init__(self, pg, rank, size, device):
        super().__init__(rank, size, device)
        self.pg = pg

    def _all_reduce(self, x):
        t = x.contiguous()
        self.pg.allreduce([t]).wait()
        return t

    def _all_gather(self, x):
        t = x.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        self.pg.allgather([parts], [t]).wait()
        return torch.cat(parts, dim=-1)


class SharedData(_Counted):
    """Collectives of ranks on one host's CPUs or one device: each rank
    writes its piece into its slot of ``bufs`` (2 parities x size slots x
    SHARED_BYTES, on the device, shared by every rank), raises its flag in
    ``flags`` (shared host memory) and waits for every flag; then each
    rank reads every slot in rank order.  Collective k uses parity k % 2: a
    rank reaches collective k + 2 only after every rank has synchronised
    its stream at collective k + 1, behind its reads of collective k."""
    kind = "shared"

    def __init__(self, rank, size, device, bufs, flags, alive,
                 timeout: float):
        super().__init__(rank, size, device)
        self.bufs, self.flags = bufs, flags.numpy()
        self.alive, self.timeout = alive, timeout
        self.epoch = 0

    def release(self) -> None:
        # a rank that exits holding a view of another process's CUDA
        # buffer leaves that process unable to free it
        self.bufs = None

    def _wait(self) -> None:
        f, e = self.flags, self.epoch
        spins, t0 = 0, time.monotonic()
        while f.min() < e:
            os.sched_yield()            # the other ranks may share the core
            spins += 1
            if spins % 4096 == 0:
                if not self.alive():
                    raise RuntimeError("a tensor-parallel rank is gone")
                if time.monotonic() - t0 > self.timeout:
                    raise TimeoutError(
                        f"tensor-parallel collective {e}: no word from "
                        f"every rank in {self.timeout:g} s")

    def _exchange(self, piece):
        """Every rank's ``piece`` (1-D, at most SHARED_BYTES), as views of
        the slots, in rank order."""
        self.epoch += 1
        nbytes = piece.numel() * piece.element_size()
        slots = self.bufs[self.epoch % 2, :, :nbytes].view(piece.dtype)
        slots[self.rank].copy_(piece)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.flags[self.rank] = self.epoch
        self._wait()
        return slots

    def _pieces(self, n: int, width: int, elem: int):
        step = max(1, SHARED_BYTES // (width * elem))
        return [(a, min(n, a + step)) for a in range(0, n, step)]

    def _all_reduce(self, x):
        flat = x.contiguous().view(-1)
        out = torch.empty_like(flat)
        for a, b in self._pieces(flat.numel(), 1, flat.element_size()):
            slots = self._exchange(flat[a:b])
            torch.add(slots[0], slots[1], out=out[a:b])
            for j in range(2, self.size):
                out[a:b].add_(slots[j])
        return out.view(x.shape)

    def _all_gather(self, x):
        c = x.shape[-1]
        rows = x.contiguous().view(-1, c)
        out = rows.new_empty((rows.shape[0], self.size * c))
        for a, b in self._pieces(rows.shape[0], c, rows.element_size()):
            slots = self._exchange(rows[a:b].reshape(-1))
            torch.cat([s.view(b - a, c) for s in slots], dim=1,
                      out=out[a:b])
        return out.view(*x.shape[:-1], self.size * c)


def _data_group(rank: int, devices, kind: str, shared, store_path,
                alive, timeout: float) -> _Counted:
    """This rank's data group: ``shared`` (bufs, flags) for "shared", a
    ``FileStore`` at ``store_path`` for NCCL's rendezvous."""
    dev = devices[rank]
    if kind == "shared":
        bufs, flags = shared
        return SharedData(rank, len(devices), dev, bufs, flags, alive,
                          timeout)
    import torch.distributed as dist

    size = len(devices)
    td = datetime.timedelta(seconds=timeout)
    store = dist.FileStore(store_path, size)
    store.set_timeout(td)
    torch.cuda.set_device(dev)
    opts = dist.ProcessGroupNCCL.Options()
    opts._timeout = td
    return NcclData(dist.ProcessGroupNCCL(store, rank, size, opts), rank,
                    size, dev)


def _worker(rank, args, devices, conn, store_path, kind, timeout, threads,
            parent) -> None:
    """A worker rank: join the data group (a "shared" group's buffers come
    first on the pipe), build the backend on this rank's shard, then run
    rank 0's calls until it says stop or goes away."""
    from repro_torch.serving.torch_backend import PagedTorchBackend

    torch.set_num_threads(threads)
    try:
        data = _data_group(rank, devices, kind,
                           conn.recv() if kind == "shared" else None,
                           store_path, lambda: os.getppid() == parent,
                           timeout)
        be = PagedTorchBackend.for_rank(args, devices, rank, data)
        conn.send(("ready", None))
        while True:
            try:
                name, a, reply = conn.recv()
            except EOFError:            # rank 0 went away
                break
            if name == "_stop":
                break
            out = getattr(be, name)(*a)
            if reply:
                conn.send(("ok", out))
        data.release()
        del be, data
    except BaseException:
        tb = traceback.format_exc()
        sys.stderr.write(f"tensor-parallel rank {rank}:\n{tb}")
        try:
            conn.send(("error", tb))
        except (OSError, ValueError):
            pass
        sys.stderr.flush()
        os._exit(1)


class TPGroup:
    """Rank 0's side of a tp-way group: the workers, their pipes, and rank
    0's own data group (``data``).

    ``args``: the backend's constructor arguments each worker builds from;
    ``devices``: one ``torch.device`` per rank, which fix the data group's
    transport (``data_kind``).  A collective, a reply or the rendezvous may
    take ``TIMEOUT`` seconds (read when the group is built).  After
    ``close``, ``exitcodes`` holds each worker's exit code."""

    def __init__(self, args: dict, devices: List[torch.device]):
        import torch.multiprocessing as mp

        self.tp = len(devices)
        self.kind = data_kind(devices)
        self.timeout = timeout = TIMEOUT
        self._procs, self._conns = [], []
        self._dir = store = None
        self.data = None
        self.exitcodes: List[int] = []
        self._closed = False
        shared = None
        if self.kind == "shared":
            shared = (torch.zeros((2, self.tp, SHARED_BYTES),
                                  dtype=torch.uint8, device=devices[0]),
                      torch.zeros(self.tp, dtype=torch.int64).share_memory_())
            if devices[0].type == "cpu":
                shared[0].share_memory_()
        else:
            self._dir = tempfile.mkdtemp(prefix="repro-tp-")
            store = os.path.join(self._dir, "store")
        ctx = mp.get_context("spawn")
        # CPU ranks split this process's threads (ranks on one host that
        # each take every core wait on each other's spinning threads)
        threads = max(1, torch.get_num_threads() // self.tp)
        try:
            for r in range(1, self.tp):
                parent, child = ctx.Pipe()
                p = ctx.Process(
                    target=_worker, name=f"tp-rank-{r}", daemon=True,
                    args=(r, args, devices, child, store, self.kind,
                          timeout, threads, os.getpid()))
                p.start()
                child.close()
                self._procs.append(p)
                self._conns.append(parent)
                if shared is not None:
                    parent.send(shared)
            self.data = _data_group(0, devices, self.kind, shared, store,
                                    self.alive, timeout)
        except BaseException:
            self.close(check=False)
            raise

    def alive(self) -> bool:
        return all(p.is_alive() for p in self._procs)

    def send(self, name: str, args: tuple, reply: bool = False) -> None:
        """Start backend method ``name`` on every worker."""
        for r, c in enumerate(self._conns, start=1):
            try:
                c.send((name, args, reply))
            except (OSError, ValueError) as e:
                raise RuntimeError(f"tensor-parallel rank {r} is gone "
                                   f"({e})") from e

    def replies(self) -> list:
        """Each worker's reply to the last call sent with ``reply``."""
        out = []
        for r, (c, p) in enumerate(zip(self._conns, self._procs), start=1):
            t0 = time.monotonic()
            while not c.poll(0.05):
                if not p.is_alive() and not c.poll(0):
                    raise RuntimeError(f"tensor-parallel rank {r} exited "
                                       f"with code {p.exitcode}")
                if time.monotonic() - t0 > self.timeout:
                    raise TimeoutError(f"tensor-parallel rank {r}: no reply "
                                       f"in {self.timeout:g} s")
            try:
                tag, val = c.recv()
            except EOFError as e:
                raise RuntimeError(f"tensor-parallel rank {r} is gone") \
                    from e
            if tag == "error":
                raise RuntimeError(f"tensor-parallel rank {r} failed:\n{val}")
            out.append(val)
        return out

    def wait_ready(self) -> None:
        """Wait until every worker has built its backend."""
        self.replies()

    def check(self, local: str) -> None:
        """Raise unless every worker's ``_token_digest`` equals rank 0's
        (``local``): the ranks sampled the same tokens."""
        self.send("_token_digest", (), reply=True)
        got = [local] + self.replies()
        if len(set(got)) != 1:
            raise RuntimeError(f"tensor-parallel ranks disagree on their "
                               f"sampled-token hashes: {got}")

    def close(self, check: bool = True) -> None:
        """Stop and join the workers (terminating any that does not stop
        within a few seconds), free the shared buffers and remove the
        store.  With ``check``, raise RuntimeError if a worker had to be
        terminated or exited with another code than 0."""
        if self._closed:
            return
        self._closed = True
        for c in self._conns:
            try:
                c.send(("_stop", (), False))
            except (OSError, ValueError):
                pass
        forced = []
        for r, p in enumerate(self._procs, start=1):
            p.join(5.0)
            if p.is_alive():
                forced.append(r)
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        self.exitcodes = [p.exitcode for p in self._procs]
        for c in self._conns:
            c.close()
        if self.data is not None:
            self.data.release()
            if self.data.device.type == "cuda" and self.kind == "shared":
                torch.cuda.ipc_collect()
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
        if check and (forced or any(self.exitcodes)):
            raise RuntimeError(
                f"tensor-parallel workers' exit codes {self.exitcodes}"
                + (f"; rank(s) {forced} terminated after not stopping in "
                   "5 s" if forced else ""))
