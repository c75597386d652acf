"""The data mesh: data parallelism over cards, one process per card.

Port of the data half of `signerf_tpu/parallel/mesh.py`. The JAX package
runs one program over a 1-D ("data",) device mesh; the port runs one
process per card on `torch.distributed` (NCCL between cards, gloo on the
CPU), and a `DataMesh` is one rank's view of that process group. Training
is data-parallel over rays, the eval render over a frame's chunks, and the
per-view generation over chunks of views; parameters are broadcast from
rank 0 and gradients averaged by one all-reduce a step.

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

The 2-D "production" ("data", "tensor") mesh and every "tensor" axis are
not ported (ROADMAP.md Queue 1); specs that name them raise.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
import time
from pathlib import Path
from typing import Any, Callable, Iterable, List, Optional, Sequence

import torch

# Seconds a collective (and the group's setup) may wait before it fails.
# The longest wait on the edit pass is rank 0's reference sheet, which
# every other rank waits for at its broadcast (~30 s at 1536 px).
DEFAULT_TIMEOUT_S = 600.0
NOT_PORTED = (
    "the 2-D production mesh and the 'tensor' axis (SDXL tensor parallelism) are not ported: "
    "ROADMAP.md Queue 1; use none, auto, data or data=K"
)
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def mesh_from_spec(spec: Optional[str], num_devices: Optional[int]) -> Optional[int]:
    """Resolve a CLI ``--mesh`` spec to the number of ranks (None: one
    device and no process group), as the JAX package's `mesh_from_spec`
    resolves it to a mesh.

    Specs: ``none`` (also ``off``, ``1``, ``false``): no process group;
    ``auto`` (the default): none on one device, else every visible device;
    ``data``: every visible device, even one (a process group of 1);
    ``data=K``: K devices. ``num_devices`` is the count of visible cards,
    or None on the CPU, where ``auto`` and ``data`` mean one process and
    ``data=K`` any K processes. ``production`` and any other axis raise.
    """
    spec = "auto" if spec is None else str(spec).strip().lower()
    available = 1 if num_devices is None else int(num_devices)
    if spec in ("none", "off", "1", "false"):
        return None
    if spec == "auto":
        return None if available == 1 else available
    if spec == "data":
        return available
    if spec == "production":
        raise ValueError(f"--mesh production: {NOT_PORTED}")
    if "=" in spec:
        sizes = {}
        for part in spec.split(","):
            name, _, size = part.partition("=")
            sizes[name.strip()] = int(size)
        if set(sizes) != {"data"}:
            raise ValueError(f"mesh spec {spec!r}: {NOT_PORTED}")
        want = sizes["data"]
        if want < 1 or (num_devices is not None and want > available):
            raise ValueError(f"mesh spec {spec!r} wants {want} devices, {available} available")
        return want
    raise ValueError(f"unknown mesh spec {spec!r} (expected none|auto|data|data=K)")


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
    """One rank of a data-parallel process group."""

    rank: int
    world_size: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        return self.rank == 0

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

    def assert_replicas_equal(self, tensors: Iterable[torch.Tensor], what: str) -> None:
        """Raise unless every rank holds the same `tensors`, by a float64
        checksum (sum and sum of squares, and the count) gathered from
        every rank and compared with rank 0's exactly."""
        total = torch.zeros(3, dtype=torch.float64, device=self.device)
        with torch.no_grad():
            for t in tensors:
                x = t.detach().to(torch.float64)
                total += torch.stack([x.sum(), (x * x).sum(), torch.tensor(float(x.numel()), device=x.device,
                                                                          dtype=torch.float64)])
        sums = self.gather_objects(total.tolist())
        if any(s != sums[0] for s in sums):
            raise RuntimeError(f"{what} differ across ranks: checksums {sums}")

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
) -> DataMesh:
    """Join the process group as `rank` of `world_size` on `device`. On a
    card the device is made current first, so that the kernels' launches
    go to it."""
    import torch.distributed as dist

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
    return DataMesh(rank=rank, world_size=world_size, device=device, backend=backend)


def launched() -> bool:
    """Whether a launcher (`torchrun`) started this process as one rank."""
    return all(k in os.environ for k in LAUNCHER_ENV)


def init_from_env(device_type: str, backend: Optional[str] = None,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> DataMesh:
    """Join the group that a launcher set up (`env://`), on card LOCAL_RANK."""
    local = int(os.environ["LOCAL_RANK"])
    device = torch.device("cuda", local) if device_type == "cuda" else torch.device("cpu")
    return init_mesh(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://", device, backend, timeout_s)


def rendezvous(directory: Path) -> str:
    """A fresh `file://` rendezvous under `directory`."""
    directory = Path(directory).resolve()
    directory.mkdir(parents=True, exist_ok=True)
    return (directory / f".rendezvous-{os.getpid()}-{time.time_ns()}").as_uri()


def _spawned(rank: int, world_size: int, init_method: str, device_type: str, backend: Optional[str],
             cards: int, timeout_s: float, fn: Callable, args: tuple) -> None:
    device = torch.device("cuda", rank % cards) if device_type == "cuda" else torch.device("cpu")
    mesh = init_mesh(rank, world_size, init_method, device, backend, timeout_s)
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
) -> None:
    """Run `fn(mesh, *args)` in `world_size` new processes (the spawn start
    method), rank r on card r % `cards` (default: one rank a card). `fn`
    must be importable by name; a nonzero int it returns is its rank's
    exit code. If a rank fails, the others are ended and this raises; so
    it does when `join_timeout_s` passes first."""
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
        _spawned, args=(world_size, init, device_type, backend, cards or 1, timeout_s, fn, args),
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
    on its group (a spec other than auto must agree with its size); with no
    group (none, or auto on one device), `fn(None, ...)` in this process,
    today's one-device path; on one rank, a group of 1 in this process;
    else `world_size` spawned ranks, one a card. Returns `fn`'s exit code
    (0 for spawned ranks that all succeed)."""
    device = torch.device(device)
    if launched():
        mesh = init_from_env(device.type)
        want = None if str(spec).strip().lower() == "auto" else mesh_from_spec(spec, mesh.world_size)
        if want not in (None, mesh.world_size):
            mesh.close()
            raise ValueError(f"--mesh {spec} asks for {want} ranks; the launcher started {mesh.world_size}")
        try:
            return fn(mesh, *args)
        finally:
            mesh.close()
    world = mesh_from_spec(spec, visible_devices(device))
    if world is None:
        return fn(None, *args)
    if world == 1:
        rank_device = torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda" else device
        init = rendezvous(rendezvous_dir)
        mesh = init_mesh(0, 1, init, rank_device)
        try:
            return fn(mesh, *args)
        finally:
            mesh.close()
            Path(init.removeprefix("file://")).unlink(missing_ok=True)
    spawn(fn, args, world, rendezvous_dir, device_type=device.type)
    return 0
