"""The ring of ranks a distributed step runs on (counterpart of
sphinxsys_tpu/parallel/mesh.py, where the ring is a 1D device mesh whose
step body runs under `shard_map`).

Here a step is a body per rank, written against a communicator:

  * `size` and `index()` (JAX: the mesh size and `lax.axis_index`);
  * `shift(tensors, direction, periodic)`: every rank sends its tensors
    one rank along the ring (+1: to the right) and receives its
    neighbour's; at a non-periodic end a rank receives zeros (JAX:
    `ppermute` with the edge pair left out, domain._perm_shift);
    `shift_both(to_right, to_left, periodic)` is both shifts in one
    exchange: (what the left neighbour sent right, what the right one
    sent left);
  * `pmax`, `pmin`, `psum` of a tensor over the ranks (`lax.pmax` ...);
    every rank gets the same value (psum adds in rank order);
  * `run(fn, pieces)`: `fn(piece)` on each of this process's ranks,
    `pieces` the rank-local parts it holds; returns their results.

Two communicators:

  * `ThreadRing(n, device)` runs n ranks in one process, one thread each,
    every exchange met by all of them, the ranks taking turns.  It is what JAX's
    virtual devices are to the JAX package (tests/conftest.py:14-15), and
    the way one card runs the ring: the ranks' launches share the card.
  * `ProcessGroupRing()` is one rank of a `torch.distributed` group (gloo
    on the CPU, NCCL across cards): the shifts are `batch_isend_irecv`,
    the reductions `all_reduce`.

Neither stands in for the other: a ring that cannot form raises.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Sequence

import torch

from sphinxsys_tpu_torch.device import resolve_device

FAR = 1.0e16
# per-field fill of the padding rows a piece gains (the JAX package pads
# a particle state this way: parked far away, finite derived quantities)
ROW_FILLS = {"Position": FAR, "InitialPosition": FAR, "Mass": 1.0,
             "Density": 1.0, "VolumetricMeasure": 1.0}


class RingBroken(RuntimeError):
    """Raised in a rank whose ring another rank's error stopped."""


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class ThreadRing:
    """n ranks in one process, one thread each (see the module doc).

    The ranks take turns: one rank's thread runs at a time, from one
    exchange to the next, then hands the turn to the next rank; the last
    rank hands it back to the first, by which time every rank has
    deposited its part of the exchange, so each reads all n parts when
    its turn comes again.  So every exchange is met by all ranks, as at
    a barrier, and only one rank's thread wants the interpreter lock at a
    time (the ranks' device work still queues on the card while another
    rank's thread runs).  The parts of consecutive exchanges go to two
    alternating slot rows: a rank writes a row again only two exchanges
    later, after every rank has read it."""

    def __init__(self, n: int, device="cuda", timeout: float = 600.0):
        if n < 1:
            raise ValueError(f"a ring needs at least one rank, not {n}")
        self.size = n
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the rank threads set this card: name it by its index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.timeout = timeout
        self._local = threading.local()
        self._cv = threading.Condition()
        self._turn = 0
        self._broken = False
        self._slots = ([None] * n, [None] * n)

    def index(self) -> int:
        rank = getattr(self._local, "rank", None)
        if rank is None:
            raise RuntimeError("ThreadRing.index() outside a rank's thread")
        return rank

    def local_ranks(self) -> list:
        return list(range(self.size))

    def _wait_turn(self, rank: int) -> None:
        with self._cv:
            if not self._cv.wait_for(lambda: self._broken or self._turn == rank,
                                     timeout=self.timeout):
                self._broken = True
                self._cv.notify_all()
                raise TimeoutError(f"rank {rank}: no turn in {self.timeout} s")
            if self._broken:
                raise RingBroken(f"rank {rank}: another rank failed")

    def _pass_turn(self, rank: int) -> None:
        with self._cv:
            self._turn = (rank + 1) % self.size
            self._cv.notify_all()

    def _exchange(self, value):
        """Deposit this rank's value; return every rank's, in rank order."""
        rank = self.index()
        gen = self._local.gen
        self._local.gen = gen + 1
        row = self._slots[gen % 2]
        row[rank] = value
        self._pass_turn(rank)
        self._wait_turn(rank)
        return list(row)

    def _from(self, got, src, periodic, like, part):
        n = self.size
        if periodic:
            src %= n
        if not 0 <= src < n:
            return [torch.zeros_like(t) for t in like]
        return [t.clone() for t in got[src][part]]

    def shift(self, tensors: Sequence[torch.Tensor], direction: int,
              periodic: bool) -> list:
        got = self._exchange((list(tensors),))
        src = self.index() - 1 if direction > 0 else self.index() + 1
        return self._from(got, src, periodic, tensors, 0)

    def shift_both(self, to_right: Sequence[torch.Tensor],
                   to_left: Sequence[torch.Tensor], periodic: bool):
        got = self._exchange((list(to_right), list(to_left)))
        rank = self.index()
        return (self._from(got, rank - 1, periodic, to_right, 0),
                self._from(got, rank + 1, periodic, to_left, 1))

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        got = self._exchange(x)
        out = got[0]
        for y in got[1:]:
            out = op(out, y)
        return out.clone() if len(got) == 1 else out

    def pmax(self, x):
        return self._reduce(x, torch.maximum)

    def pmin(self, x):
        return self._reduce(x, torch.minimum)

    def psum(self, x):
        return self._reduce(x, torch.add)

    def run(self, fn: Callable, pieces: Sequence) -> list:
        """fn(piece) on every rank, each in a thread of its own; returns the
        results in rank order.  A rank that raises stops the others (they
        raise RingBroken), and its error is raised here."""
        if len(pieces) != self.size:
            raise ValueError(f"{len(pieces)} pieces for a ring of {self.size}")
        self._turn, self._broken = 0, False
        results: list = [None] * self.size
        errors: list = [None] * self.size

        def work(rank):
            self._local.rank = rank
            self._local.gen = 0
            try:
                self._wait_turn(rank)
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                results[rank] = fn(pieces[rank])
                self._pass_turn(rank)
            except BaseException as exc:     # noqa: BLE001 - re-raised below
                errors[rank] = exc
                with self._cv:
                    self._broken = True
                    self._cv.notify_all()

        threads = [threading.Thread(target=work, args=(r,), daemon=True)
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        first = next((e for e in errors if e is not None
                      and not isinstance(e, RingBroken)),
                     next((e for e in errors if e is not None), None))
        if first is not None:
            raise first
        return results


class ProcessGroupRing:
    """This process's rank of an initialised `torch.distributed` group
    (see the module doc).  The group is the caller's to form
    (`init_process_group` with its address, world size and rank); one
    that is not formed raises."""

    def __init__(self, device=None):
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("ProcessGroupRing needs an initialised "
                               "torch.distributed process group")
        self._dist = dist
        self.size = dist.get_world_size()
        self._rank = dist.get_rank()
        backend = dist.get_backend()
        if device is None:
            device = f"cuda:{torch.cuda.current_device()}" \
                if backend == "nccl" else "cpu"
        self.device = resolve_device(device)

    def index(self) -> int:
        return self._rank

    def local_ranks(self) -> list:
        return [self._rank]

    def shift(self, tensors: Sequence[torch.Tensor], direction: int,
              periodic: bool) -> list:
        dist, n, rank = self._dist, self.size, self._rank
        dst, src = (rank + 1, rank - 1) if direction > 0 else (rank - 1, rank + 1)
        if periodic:
            dst, src = dst % n, src % n
        out = [torch.zeros_like(t) for t in tensors]
        ops = []
        for t, o in zip(tensors, out):
            if 0 <= dst < n:
                ops.append(dist.P2POp(dist.isend, t.contiguous(), dst))
            if 0 <= src < n:
                ops.append(dist.P2POp(dist.irecv, o, src))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def shift_both(self, to_right: Sequence[torch.Tensor],
                   to_left: Sequence[torch.Tensor], periodic: bool):
        dist, n, rank = self._dist, self.size, self._rank
        right, left = rank + 1, rank - 1
        if periodic:
            right, left = right % n, left % n
        from_left = [torch.zeros_like(t) for t in to_right]
        from_right = [torch.zeros_like(t) for t in to_left]
        ops = []
        for send, recv, dst, src in ((to_right, from_left, right, left),
                                     (to_left, from_right, left, right)):
            for t, o in zip(send, recv):
                if 0 <= dst < n:
                    ops.append(dist.P2POp(dist.isend, t.contiguous(), dst))
                if 0 <= src < n:
                    ops.append(dist.P2POp(dist.irecv, o, src))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return from_left, from_right

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        y = x.clone()
        self._dist.all_reduce(y, op=op)
        return y

    def pmax(self, x):
        return self._reduce(x, self._dist.ReduceOp.MAX)

    def pmin(self, x):
        return self._reduce(x, self._dist.ReduceOp.MIN)

    def psum(self, x):
        return self._reduce(x, self._dist.ReduceOp.SUM)

    def run(self, fn: Callable, pieces: Sequence) -> list:
        if len(pieces) != 1:
            raise ValueError(f"a process holds one rank's piece, not "
                             f"{len(pieces)}")
        return [fn(pieces[0])]


def make_particle_mesh(n_devices: int, device="cuda", kind: str = "thread"):
    """A ring of n ranks: `kind="thread"` a ThreadRing on `device`;
    `kind="process"` this process's ProcessGroupRing, whose group must
    have n ranks."""
    if kind == "thread":
        return ThreadRing(n_devices, device)
    if kind == "process":
        ring = ProcessGroupRing(device)
        if ring.size != n_devices:
            raise ValueError(f"the process group has {ring.size} ranks, "
                             f"not {n_devices}")
        return ring
    raise ValueError(f"unknown ring kind {kind!r}")


def _split(v: torch.Tensor, n_dev: int, take: int, rows: int, fill) -> list:
    """v's leading axis in n_dev contiguous runs of `take` rows (the last
    ones shorter), each padded with `fill` to `rows` rows."""
    out = []
    for r in range(n_dev):
        part = v[r * take:(r + 1) * take]
        pad = rows - part.shape[0]
        if pad:
            part = torch.cat([part, torch.full((pad,) + tuple(v.shape[1:]),
                                               fill, dtype=v.dtype,
                                               device=v.device)])
        out.append(part)
    return out


def shard_state(state: dict, ring, multiple: int = 1) -> list:
    """A particle state's rank pieces: every (N, ...) field (N the
    Position rows) split along its particle axis into `ring.size`
    contiguous runs of ceil(N / size) rows, each padded to a multiple of
    `multiple` rows (ROW_FILLS; 0 elsewhere); every other value is given
    to each piece as it is.  Each piece's "NReal" counts its real rows
    (those below the state's NReal)."""
    n_dev = ring.size
    n = state["Position"].shape[0]
    take = -(-n // n_dev)
    rows = round_up(take, multiple)
    pieces = [dict() for _ in range(n_dev)]
    for k, v in state.items():
        if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == n:
            fill = 0 if not v.is_floating_point() else ROW_FILLS.get(k, 0.0)
            for p, part in zip(pieces, _split(v, n_dev, take, rows, fill)):
                p[k] = part
        else:
            for p in pieces:
                p[k] = v
    n_real = int(state.get("NReal", n))
    for r, p in enumerate(pieces):
        p["NReal"] = max(0, min(take, n_real - r * take))
    return pieces


def shard_pytree_leaves(tree: Any, ring) -> list:
    """The rank pieces of a nested structure (dicts, lists, tuples,
    dataclass-free): each tensor whose leading axis divides by the ring's
    size, and is at least it, is split into equal contiguous pieces; every
    other leaf is given to each piece."""
    n_dev = ring.size

    def split(v):
        if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] >= n_dev \
                and v.shape[0] % n_dev == 0:
            return list(v.reshape((n_dev, v.shape[0] // n_dev)
                                  + tuple(v.shape[1:])).unbind(0))
        if isinstance(v, dict):
            parts = {k: split(x) for k, x in v.items()}
            return [{k: parts[k][r] for k in v} for r in range(n_dev)]
        if isinstance(v, (list, tuple)):
            parts = [split(x) for x in v]
            return [type(v)(p[r] for p in parts) for r in range(n_dev)]
        return [v] * n_dev

    return split(tree)
