"""The (dp, sp) encode mesh and multi-process initialization.

Deployment model, as sjpeg_tpu.parallel.mesh lays it out: a 2-D mesh
where `dp` shards batches of images (across processes: each process feeds
its local images) and `sp` shards MCU-row stripes within an image over the
devices of one process.  A single controller in each process drives its
local grid of devices (its dp rows times sp): every sp "collective" of the
encode (the sums of histograms and symbol frequencies, the hand-over of
each stripe's last DC predictors, the gather of stripe streams) is a copy
between the process's own devices.  Across processes nothing moves but a
check that every process encodes a batch of the same shape, so the
process group is gloo, over the host.

A device may repeat in the grid: `make_mesh(2, 2, [cuda:0] * 4)` runs a
(2, 2) mesh on one card (its stripes then run one after another), and CPU
devices give the same mesh on the CPU.
"""

from typing import Optional

import torch
import torch.distributed as dist


class Mesh:
    """`dp` x `sp` encode mesh.  `devices` is this process's grid: `dp_local`
    rows (dp // world) of `sp` torch.devices; `rank` and `world` place the
    process on dp."""

    def __init__(self, devices, dp: int, sp: int, rank: int = 0,
                 world: int = 1):
        devices = [[torch.device(d) for d in row] for row in devices]
        if dp % world or len(devices) != dp // world or any(
                len(row) != sp for row in devices):
            raise ValueError(f"a ({dp}, {sp}) mesh over {world} processes "
                             f"needs {dp // max(world, 1)} local rows of "
                             f"{sp} devices")
        self.devices, self.dp, self.sp = devices, dp, sp
        self.rank, self.world = rank, world

    @property
    def dp_local(self) -> int:
        return len(self.devices)

    def lead(self, row: int = 0) -> torch.device:
        """The device that holds dp row `row`'s sums and its stitch."""
        return self.devices[row][0]

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, sp={self.sp}, rank={self.rank}, "
                f"world={self.world}, devices={self.devices})")


def _rank_and_world():
    """(rank, world size) of the default process group, (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> None:
    """Join the process group the sharded API checks shapes over (gloo:
    only host metadata crosses processes).  A no-op when one is already
    initialized.  `init_method` defaults to "env://" (MASTER_ADDR,
    MASTER_PORT, RANK and WORLD_SIZE); "file://<path>" needs no port."""
    if dist.is_initialized():
        return
    kw = {}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group("gloo", init_method=init_method or "env://",
                            **kw)


def local_devices() -> list:
    """This process's CUDA devices; raises without CUDA (pass CPU devices
    to run on the CPU)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("CUDA is not available; the mesh holds CUDA "
                           "devices unless the caller passes CPU devices")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(dp: Optional[int] = None, sp: Optional[int] = None,
              devices=None) -> Mesh:
    """Build the (dp, sp) encode mesh over this process's `devices` (the
    local CUDA devices by default) and the processes of the group.

    Defaults, as sjpeg_tpu.parallel.mesh.make_mesh: dp = the number of
    processes, so image batches shard per process, and sp = the local
    device count.  With explicit dp / sp, dp * sp must equal the local
    device count times the number of processes, and dp must divide by the
    number of processes (each process holds whole dp rows)."""
    devices = list(devices) if devices is not None else local_devices()
    rank, world = _rank_and_world()
    n = len(devices) * world
    if dp is None and sp is None:
        dp = world
        sp = n // dp
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"dp ({dp}) * sp ({sp}) != devices ({n})")
    rows = dp // world
    return Mesh([devices[r * sp:(r + 1) * sp] for r in range(rows)], dp, sp,
                rank, world)


def default_mesh(devices=None) -> Mesh:
    """Every local device on the stripe (sp) axis: dp = 1 in a single
    process (one dp row a process under a process group)."""
    devices = list(devices) if devices is not None else local_devices()
    return make_mesh(sp=len(devices), devices=devices)
