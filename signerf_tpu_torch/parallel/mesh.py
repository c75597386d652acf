"""The device mesh: data and tensor parallelism over cards, one process per card.

Port of `signerf_tpu/parallel/mesh.py`. The JAX package runs one program
over a ("data",) or ("data", "tensor") device mesh; the port runs one
process per card on `torch.distributed` (NCCL between cards, gloo on the
CPU), and a `DataMesh` is one rank's view of that process group. Training
is data-parallel over rays on every rank, the eval render over a frame's
chunks, and the per-view generation over chunks of views; parameters are
broadcast from rank 0 and gradients averaged by one all-reduce a step.

A mesh of shape (data, tensor) = (K, T) has W = K * T ranks. Its tensor
groups are the K runs of T consecutive ranks (JAX's
`reshape((n // T, T))` makes "tensor" the fast axis too): the SDXL UNet
and ControlNet are sharded over a tensor group (`diffusion/unet.py`), and
the generator deals its chunks of views over the K groups, a group's ranks
running each of its chunks together. `world_size`, `share`, `all_mean_`
and `assemble` mean the whole world, so the NeRF paths are the same on
every shape.

The collectives used are `all_reduce` (SUM), `broadcast`, `barrier` and
`all_gather_object`, which NCCL and gloo both support on CUDA tensors.
Gathers are assembled as a zero-filled buffer that each rank fills with its
part, then summed: adding zeros is exact.

A multi-card run starts in one of two ways. Under a launcher
(`torchrun --nproc-per-node 4 -m signerf_tpu_torch.train ...`), each
process joins the group from the launcher's environment. Without one, a
spec that asks for more than one card makes `run` spawn its own workers
(the spawn start method, a `file://` rendezvous in the run's output
directory), so that `python -m signerf_tpu_torch.train ...` on a four-card
host uses all four, as the JAX CLI does on a v5e-8.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
import time
from pathlib import Path
from typing import Any, Callable, Iterable, List, NamedTuple, Optional, Sequence

import torch

# Seconds a collective (and the group's setup) may wait before it fails.
# The longest wait on the edit pass is rank 0's reference sheet, which
# every other rank waits for at its broadcast (~30 s at 1536 px).
DEFAULT_TIMEOUT_S = 600.0
PRODUCTION_TENSOR = 2  # `production_mesh`'s default tensor size
AXES = ("data", "tensor")
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


class MeshShape(NamedTuple):
    """A mesh's (data, tensor) sizes: K view groups of T ranks each."""

    data: int
    tensor: int = 1

    @property
    def size(self) -> int:
        return self.data * self.tensor


def production_shape(num_devices: int, tensor: int = PRODUCTION_TENSOR) -> MeshShape:
    """The 2-D edit-pass layout with UNet tensor parallelism, (n / T, T), as
    JAX's `production_mesh` builds it (and refuses an n that T does not
    divide). Not the default: `auto` resolves to the data mesh."""
    if num_devices % tensor:
        raise ValueError(f"{num_devices} devices not divisible by tensor={tensor}")
    return MeshShape(num_devices // tensor, tensor)


def mesh_from_spec(spec: Optional[str], num_devices: Optional[int]) -> Optional[MeshShape]:
    """Resolve a CLI ``--mesh`` spec to the mesh's (data, tensor) shape
    (None: one device and no process group), as the JAX package's
    `mesh_from_spec` resolves it to a mesh.

    Specs: ``none`` (also ``off``, ``1``, ``false``): no process group;
    ``auto`` (the default): none on one device, else every visible device
    as the data mesh; ``data``: every visible device, even one (a process
    group of 1); ``production``: (n / 2, 2), refused for an odd n;
    ``data=K``, ``tensor=T`` or ``data=K,tensor=T``: K x T devices, refused
    above the visible count. ``num_devices`` is the count of visible cards,
    or None on the CPU, where ``auto`` and ``data`` mean one process,
    ``production`` is refused and explicit sizes take any count. Axis
    names other than data and tensor raise.
    """
    spec = "auto" if spec is None else str(spec).strip().lower()
    available = 1 if num_devices is None else int(num_devices)
    if spec in ("none", "off", "1", "false"):
        return None
    if spec == "auto":
        return None if available == 1 else MeshShape(available)
    if spec == "data":
        return MeshShape(available)
    if spec == "production":
        return production_shape(available)
    if "=" in spec:
        sizes = {}
        for part in spec.split(","):
            name, _, size = part.partition("=")
            sizes[name.strip()] = int(size)
        if not set(sizes) <= set(AXES):
            raise ValueError(f"mesh spec {spec!r}: the port's axes are {' and '.join(AXES)}")
        shape = MeshShape(sizes.get("data", 1), sizes.get("tensor", 1))
        if min(shape) < 1 or (num_devices is not None and shape.size > available):
            raise ValueError(f"mesh spec {spec!r} wants {shape.size} devices, {available} available")
        return shape
    raise ValueError(f"unknown mesh spec {spec!r} (expected none|auto|data|production|data=K[,tensor=T]|tensor=T)")


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s sampling generator: `seed` itself on rank
    0, a hash of (seed, rank) elsewhere (the counterpart of JAX's
    `fold_in(key, axis_index)`)."""
    if rank == 0:
        return int(seed)
    digest = hashlib.sha256(f"{int(seed)}:{int(rank)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


@dataclasses.dataclass
class DataMesh:
    """One rank of a process group of shape (world_size / tensor, tensor)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    tensor: int = 1  # T: the size of each tensor group
    # This rank's tensor group (ranks T * g to T * g + T - 1), a
    # `dist.new_group`; None when T is 1.
    tensor_group: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def view_group(self) -> int:
        """g: the index of this rank's tensor group, which takes every
        (W / T)-th chunk of views from the g-th on."""
        return self.rank // self.tensor

    @property
    def view_groups(self) -> int:
        return self.world_size // self.tensor

    @property
    def tensor_rank(self) -> int:
        """r: this rank's place in its tensor group (its shard of the heads)."""
        return self.rank % self.tensor

    def tensor_all_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over this rank's tensor group in place."""
        if self.tensor > 1:
            import torch.distributed as dist

            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.tensor_group)
        return t

    def share(self, n: int) -> slice:
        """This rank's contiguous share of a leading dimension of n."""
        return slice(n * self.rank // self.world_size, n * (self.rank + 1) // self.world_size)

    def all_sum_(self, flat: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        return flat

    def all_mean_(self, flat: torch.Tensor) -> torch.Tensor:
        """Average `flat` over the ranks in place (SUM, then / W: gloo has no AVG)."""
        return self.all_sum_(flat).div_(self.world_size)

    def assemble(self, local: torch.Tensor, n: int, start: int) -> torch.Tensor:
        """The [n, ...] tensor whose rows [start, start + len(local)) are
        this rank's `local` and the rest the other ranks' parts, on every
        rank: a zero-filled buffer, filled, then summed."""
        buf = torch.zeros((n, *local.shape[1:]), dtype=local.dtype, device=local.device)
        buf[start : start + local.shape[0]] = local
        return self.all_sum_(buf)

    def broadcast_(self, tensors: Iterable[torch.Tensor], src: int = 0) -> None:
        import torch.distributed as dist

        for t in tensors:
            dist.broadcast(t, src=src)

    def broadcast_module_(self, module: torch.nn.Module) -> None:
        """Give every rank rank 0's parameters and buffers."""
        with torch.no_grad():
            self.broadcast_([*(p.data for p in module.parameters()), *module.buffers()])

    def broadcast_tensors(self, tensors: Optional[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
        """Rank 0's `tensors` on every rank (the others pass None): shapes
        and dtypes travel by `all_gather_object`, the data by broadcast."""
        meta = self.gather_objects(
            [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in tensors] if self.is_main else None
        )[0]
        if self.is_main:
            out = [t.contiguous() for t in tensors]
        else:
            out = [torch.empty(shape, dtype=getattr(torch, dtype), device=self.device) for shape, dtype in meta]
        self.broadcast_(out)
        return out

    def gather_objects(self, obj: Any) -> List[Any]:
        """Every rank's `obj`, in rank order, on every rank."""
        import torch.distributed as dist

        out: List[Any] = [None] * self.world_size
        dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier()

    def print(self, *args, **kwargs) -> None:
        """`print` on rank 0 only."""
        if self.is_main:
            print(*args, **kwargs)

    def _checksum(self, tensors: Iterable[torch.Tensor]) -> List[float]:
        """A float64 checksum: the sum, the sum of squares and the count."""
        total = torch.zeros(3, dtype=torch.float64, device=self.device)
        with torch.no_grad():
            for t in tensors:
                x = t.detach().to(torch.float64)
                total += torch.stack([x.sum(), (x * x).sum(), torch.tensor(float(x.numel()), device=x.device,
                                                                          dtype=torch.float64)])
        return total.tolist()

    def assert_replicas_equal(self, tensors: Iterable[torch.Tensor], what: str,
                              sharded: Iterable[torch.Tensor] = ()) -> None:
        """Raise unless every rank holds the same `tensors`, and every rank
        of one place in its tensor group the same `sharded` tensors (the
        same shard across the view groups), by checksums gathered from
        every rank and compared exactly."""
        sums = self.gather_objects((self.tensor_rank, self._checksum(tensors), self._checksum(sharded)))
        if any(s[1] != sums[0][1] for s in sums):
            raise RuntimeError(f"{what} differ across ranks: checksums {[s[1] for s in sums]}")
        for r in range(self.tensor):
            shards = [s[2] for s in sums if s[0] == r]
            if any(s != shards[0] for s in shards):
                raise RuntimeError(f"{what}: shard {r} differs across the view groups: checksums {shards}")

    def close(self) -> None:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def default_backend(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_mesh(
    rank: int,
    world_size: int,
    init_method: str,
    device: torch.device,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    tensor: int = 1,
) -> DataMesh:
    """Join the process group as `rank` of `world_size` on `device`, with
    tensor groups of `tensor` consecutive ranks. On a card the device is
    made current first, so that the kernels' launches go to it."""
    import torch.distributed as dist

    if tensor < 1 or world_size % tensor:
        raise ValueError(f"tensor={tensor} does not divide {world_size} ranks")
    device = torch.device(device)
    backend = backend or default_backend(device)
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs,
    )
    group = None
    if tensor > 1:
        # every rank makes every group, in the same order, as new_group requires
        for g in range(world_size // tensor):
            made = dist.new_group(list(range(g * tensor, (g + 1) * tensor)))
            if g == rank // tensor:
                group = made
    return DataMesh(rank=rank, world_size=world_size, device=device, backend=backend, tensor=tensor,
                    tensor_group=group)


def launched() -> bool:
    """Whether a launcher (`torchrun`) started this process as one rank."""
    return all(k in os.environ for k in LAUNCHER_ENV)


def init_from_env(device_type: str, backend: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S,
                  tensor: int = 1) -> DataMesh:
    """Join the group that a launcher set up (`env://`), on card LOCAL_RANK."""
    local = int(os.environ["LOCAL_RANK"])
    device = torch.device("cuda", local) if device_type == "cuda" else torch.device("cpu")
    return init_mesh(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://", device, backend, timeout_s,
                     tensor)


def rendezvous(directory: Path) -> str:
    """A fresh `file://` rendezvous under `directory`."""
    directory = Path(directory).resolve()
    directory.mkdir(parents=True, exist_ok=True)
    return (directory / f".rendezvous-{os.getpid()}-{time.time_ns()}").as_uri()


def _spawned(rank: int, world_size: int, init_method: str, device_type: str, backend: Optional[str],
             cards: int, timeout_s: float, tensor: int, fn: Callable, args: tuple) -> None:
    device = torch.device("cuda", rank % cards) if device_type == "cuda" else torch.device("cpu")
    mesh = init_mesh(rank, world_size, init_method, device, backend, timeout_s, tensor)
    rc = fn(mesh, *args)
    mesh.close()
    if isinstance(rc, int) and rc:
        raise SystemExit(rc)


def spawn(
    fn: Callable,
    args: tuple,
    world_size: int,
    rendezvous_dir: Path,
    device_type: str = "cuda",
    backend: Optional[str] = None,
    cards: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    join_timeout_s: Optional[float] = None,
    tensor: int = 1,
) -> None:
    """Run `fn(mesh, *args)` in `world_size` new processes (the spawn start
    method), rank r on card r % `cards` (default: one rank a card), in
    tensor groups of `tensor` ranks. `fn` must be importable by name; a
    nonzero int it returns is its rank's exit code. If a rank fails, the
    others are ended and this raises; so it does when `join_timeout_s`
    passes first."""
    import torch.multiprocessing as mp

    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if device_type == "cuda":
        visible = torch.cuda.device_count()
        cards = cards or visible
        if cards > visible or (backend == "nccl" and world_size > cards):
            raise ValueError(f"{world_size} {backend} ranks on {cards} of {visible} visible cards: NCCL needs "
                             "a card a rank")
    init = rendezvous(rendezvous_dir)
    ctx = mp.start_processes(
        _spawned, args=(world_size, init, device_type, backend, cards or 1, timeout_s, tensor, fn, args),
        nprocs=world_size, join=False, start_method="spawn",
    )
    deadline = None if join_timeout_s is None else time.monotonic() + join_timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks did not finish within {join_timeout_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
            if proc.is_alive():
                proc.kill()
        Path(init.removeprefix("file://")).unlink(missing_ok=True)


def visible_devices(device: torch.device) -> Optional[int]:
    """Cards a spec may take on `device`'s type (None on the CPU: any)."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else None


def run(spec: Optional[str], device: torch.device, rendezvous_dir: Path, fn: Callable, args: tuple = ()) -> int:
    """The CLIs' entry: `fn(mesh, *args)` as `spec` says. Under a launcher,
    on its group (a spec other than auto must agree with its size; its
    tensor size shapes the groups); with no group (none, or auto on one
    device), `fn(None, ...)` in this process, today's one-device path; on
    one rank, a group of 1 in this process; else `data x tensor` spawned
    ranks, one a card. Returns `fn`'s exit code (0 for spawned ranks that
    all succeed)."""
    device = torch.device(device)
    if launched():
        world = int(os.environ["WORLD_SIZE"])
        want = None if str(spec).strip().lower() == "auto" else mesh_from_spec(spec, world)
        if want is not None and want.size != world:
            raise ValueError(f"--mesh {spec} asks for {want.size} ranks; the launcher started {world}")
        mesh = init_from_env(device.type, tensor=1 if want is None else want.tensor)
        try:
            return fn(mesh, *args)
        finally:
            mesh.close()
    shape = mesh_from_spec(spec, visible_devices(device))
    if shape is None:
        return fn(None, *args)
    if shape.size == 1:
        rank_device = torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda" else device
        init = rendezvous(rendezvous_dir)
        mesh = init_mesh(0, 1, init, rank_device)
        try:
            return fn(mesh, *args)
        finally:
            mesh.close()
            Path(init.removeprefix("file://")).unlink(missing_ok=True)
    spawn(fn, args, shape.size, rendezvous_dir, device_type=device.type, tensor=shape.tensor)
    return 0
