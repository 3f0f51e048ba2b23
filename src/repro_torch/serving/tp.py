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

Ranks as a grid: ``run_grid`` runs a function on every rank of a (data,
model) ``launch.mesh.Mesh`` (expert parallelism, ``models.moe.moe_ep``),
each rank holding the data group of each axis's line through it
(``grid_groups``); the groups add ``all_to_all`` to the collectives
above.  Shared groups get buffers of their own; NCCL
groups are process groups of their own over one store (written, and not
run: the GPU machine this port is measured on has one card, and NCCL
refuses two ranks on one).
"""

from __future__ import annotations

import datetime
import os
import pickle
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
        """The sum of every rank's ``x`` (a group of one: ``x``)."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        out = self._all_reduce(x)
        self.n += 1
        self.seconds += time.perf_counter() - t0
        return out

    def all_gather(self, x, dim: int = -1):
        """Every rank's ``x``, joined on ``dim`` in rank order."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        if dim % x.dim() == x.dim() - 1:
            out = self._all_gather(x)
        else:
            out = self._all_gather(x.movedim(dim, -1)).movedim(-1, dim)
        self.n += 1
        self.seconds += time.perf_counter() - t0
        return out

    def all_to_all(self, x):
        """Piece j of ``x`` along dim 0 (its length the group's size) to
        rank j: row j of the result is what rank j sent this rank."""
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} must "
                             f"be the group's size {self.size}")
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        out = self._all_to_all(x.contiguous())
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

    def _all_to_all(self, x):
        out = torch.empty_like(x)
        self.pg.alltoall_base(out, x, [], []).wait()
        return out


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
        self.slot_bytes = bufs.shape[2]
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
        step = max(1, self.slot_bytes // (width * elem))
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

    def _all_to_all(self, x):
        n = self.size
        cols = x.view(n, -1)
        out = torch.empty_like(cols)
        for a, b in self._pieces(cols.shape[1], n, cols.element_size()):
            slots = self._exchange(cols[:, a:b].reshape(-1))
            for j in range(n):
                out[j, a:b] = slots[j].view(n, b - a)[self.rank]
        return out.view(x.shape)


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


# ---------------------------------------------------------------------------
# Ranks laid out as a grid (expert parallelism over a (data, model) mesh)
# ---------------------------------------------------------------------------
def _line_groups(mesh) -> dict:
    """Per axis, the rank tuples of its lines (ranks that differ along that
    axis alone)."""
    out = {}
    for axis in mesh.axis_names:
        lines = sorted({mesh.group(r, axis) for r in range(mesh.size)})
        out[axis] = lines
    return out


def _grid_shared(mesh, slot_bytes: int) -> dict:
    """Shared buffers and flags of every line group of ``mesh`` (ranks on
    the CPU or on one card): {(axis, line index): (bufs, flags)}."""
    dev = mesh.devices[0]
    out = {}
    for axis, lines in _line_groups(mesh).items():
        for i, line in enumerate(lines):
            bufs = torch.zeros((2, len(line), slot_bytes), dtype=torch.uint8,
                               device=dev)
            if dev.type == "cpu":
                bufs.share_memory_()
            flags = torch.zeros(len(line), dtype=torch.int64).share_memory_()
            out[axis, i] = (bufs, flags)
    return out


def grid_groups(rank: int, mesh, kind: str, shared, store_path, alive,
                timeout: float) -> dict:
    """Rank ``rank``'s data groups on ``mesh``: {axis: the ranks along
    that axis through this one}, each ranked by its index on the line.  "shared" groups take their buffers from ``shared``
    (``_grid_shared``); NCCL groups are process groups of their own over
    one ``FileStore`` at ``store_path`` (keys prefixed per line)."""
    dev = mesh.devices[rank]
    groups = {}
    if kind == "nccl":
        import torch.distributed as dist

        td = datetime.timedelta(seconds=timeout)
        store = dist.FileStore(store_path, mesh.size)
        store.set_timeout(td)
        torch.cuda.set_device(dev)
    for axis, lines in _line_groups(mesh).items():
        i = next(i for i, line in enumerate(lines) if rank in line)
        line = lines[i]
        r = line.index(rank)
        if kind == "shared":
            bufs, flags = shared[axis, i]
            groups[axis] = SharedData(r, len(line), dev, bufs, flags, alive,
                                      timeout)
        else:
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = td
            pg = dist.ProcessGroupNCCL(
                dist.PrefixStore(f"{axis}/{i}", store), r, len(line), opts)
            groups[axis] = NcclData(pg, r, len(line), dev)
    return groups


def _grid_worker(rank, fn, args, mesh, conn, store_path, kind, timeout,
                 threads, parent) -> None:
    """A worker rank of ``run_grid``: join the groups, run ``fn``, send its
    result back, release the groups and exit."""
    torch.set_num_threads(threads)
    try:
        shared = conn.recv() if kind == "shared" else None
        groups = grid_groups(rank, mesh, kind, shared, store_path,
                             lambda: os.getppid() == parent, timeout)
        # plain pickle bytes: a tensor sent as a shared-memory handle would
        # die with this process
        out = pickle.dumps(fn(groups, rank, *args))
        conn.send(("ok", out))
        for g in groups.values():
            g.release()
        del groups, shared
    except BaseException:
        tb = traceback.format_exc()
        sys.stderr.write(f"grid rank {rank}:\n{tb}")
        try:
            conn.send(("error", tb))
        except (OSError, ValueError):
            pass
        sys.stderr.flush()
        os._exit(1)


def run_grid(fn, mesh, args: tuple = (), slot_bytes: int = SHARED_BYTES,
             timeout: float = None):
    """Run ``fn(groups, rank, *args)`` on every rank of ``mesh`` (a
    ``launch.mesh.Mesh`` with devices): this process is rank 0, ranks
    1..n-1 are workers started with the "spawn" method (``fn`` must be
    importable by name; its result is sent back through a pipe, so keep it
    on the host).  ``groups`` are the rank's data groups (``grid_groups``;
    the transport follows ``data_kind`` of the devices).  Returns (results,
    exit codes): every rank's result in rank order and each worker's exit
    code.  Raises if any rank fails, or if a worker exits with another code
    than 0."""
    import torch.multiprocessing as mp

    timeout = TIMEOUT if timeout is None else timeout
    devices = list(mesh.devices)
    kind = data_kind(devices)
    shared = _grid_shared(mesh, slot_bytes) if kind == "shared" else None
    tmp = None if kind == "shared" else tempfile.mkdtemp(prefix="repro-grid-")
    store = None if tmp is None else os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    threads = max(1, torch.get_num_threads() // mesh.size)
    procs, conns = [], []
    groups = None
    try:
        for r in range(1, mesh.size):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_grid_worker, name=f"grid-rank-{r}",
                            daemon=True,
                            args=(r, fn, args, mesh, child, store, kind,
                                  timeout, threads, os.getpid()))
            p.start()
            child.close()
            procs.append(p)
            conns.append(parent)
            if shared is not None:
                parent.send(shared)
        groups = grid_groups(0, mesh, kind, shared, store,
                             lambda: all(p.is_alive() for p in procs),
                             timeout)
        results = [fn(groups, 0, *args)]
        for r, (c, p) in enumerate(zip(conns, procs), start=1):
            t0 = time.monotonic()
            while not c.poll(0.05):
                if not p.is_alive() and not c.poll(0):
                    raise RuntimeError(f"grid rank {r} exited with code "
                                       f"{p.exitcode}")
                if time.monotonic() - t0 > timeout:
                    raise TimeoutError(f"grid rank {r}: no result in "
                                       f"{timeout:g} s")
            tag, val = c.recv()
            if tag == "error":
                raise RuntimeError(f"grid rank {r} failed:\n{val}")
            results.append(pickle.loads(val))
    finally:
        for p in procs:
            p.join(10.0)
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        for c in conns:
            c.close()
        if groups is not None:
            for g in groups.values():
                g.release()
        del groups, shared
        if devices[0].type == "cuda" and kind == "shared":
            torch.cuda.ipc_collect()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"grid workers' exit codes {codes}")
    return results, codes
