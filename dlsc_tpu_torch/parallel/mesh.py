"""Process groups, the device mesh, the rank's share of a global batch, and
the launcher that starts the ranks.

Counterpart of ``dlsc_tpu/parallel/mesh.py``. JAX runs one process over a
mesh of devices; PyTorch runs one process per rank, so the port adds what
the JAX package gets from its runtime:

- ``init_distributed`` joins a process group, from torchrun's environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``) or
  from an explicit rank, world size and ``init_method``. The backend is
  NCCL for CUDA and gloo for the CPU unless it is given: it is never chosen
  by catching an error. A CUDA rank takes ``cuda:LOCAL_RANK``;
- ``get_mesh`` builds the ('data', 'model') ``DeviceMesh`` with the JAX
  errors (``mesh.py:44-46``);
- ``MeshPlan`` keeps ``n_data`` and ``pad_batch`` and adds what a rank of a
  data-parallel step needs: the mesh axes its global batch is split over
  and its row slice of that batch (``rows``). ``batch_size`` stays the
  global batch, as under the JAX mesh;
- ``shard_batch`` is a host batch's rows of this rank; ``replicate``
  broadcasts tensors from rank 0; ``broadcast_object`` and
  ``gather_objects`` move picklable host values (gloo has only all-reduce
  and broadcast for CUDA tensors; its object collectives go through host
  tensors);
- ``spawn`` starts N ranks (``multiprocessing`` with the ``spawn`` method,
  a ``file://`` rendezvous), each with a process-group timeout, and joins
  them with a limit: a rank that dies leaves the others waiting in a
  collective, so the parent ends them all and raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: timeout of a collective (seconds): a rank that hangs fails its group
#: after this long instead of holding it forever
GROUP_TIMEOUT_S = 300


def default_backend(device_type: str) -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks."""
    return "nccl" if device_type == "cuda" else "gloo"


def local_device(device_type: str) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK`` (0 when unset), or the CPU.
    A ``LOCAL_RANK`` beyond the visible cards raises."""
    if device_type != "cuda":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", 0))
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK={local} but only {torch.cuda.device_count()} GPU(s) "
                           "are visible")
    return torch.device("cuda", local)


def init_distributed(backend: str | None = None, *, device_type: str = "cuda",
                     rank: int | None = None, world_size: int | None = None,
                     init_method: str | None = None,
                     timeout_s: float = GROUP_TIMEOUT_S) -> torch.device:
    """Join the default process group and return this rank's device.

    With ``rank`` None the group comes from torchrun's environment
    (``init_method='env://'``); otherwise from ``rank``, ``world_size`` and
    ``init_method`` (a ``file://`` or ``tcp://localhost:<port>`` address).
    ``backend`` defaults to ``default_backend(device_type)``."""
    device = local_device(device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw: dict[str, Any] = dict(backend=backend or default_backend(device_type),
                              timeout=datetime.timedelta(seconds=timeout_s))
    if rank is None:
        kw["init_method"] = "env://"
    else:
        kw.update(init_method=init_method, rank=rank, world_size=world_size)
    dist.init_process_group(**kw)
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_mesh(n_devices: int | None = None, model_parallel: int = 1,
             device_type: str = "cuda", axes: tuple[str, str] = ("data", "model")
             ) -> DeviceMesh:
    """The (data, model) ``DeviceMesh`` over the group's ranks;
    ``model_parallel`` ranks on the second axis. ``n_devices`` must be the
    group's size (one process per device)."""
    n = world_size() if n_devices is None else int(n_devices)
    if n != world_size():
        raise ValueError(f"a mesh of {n} devices needs {n} ranks; the process group has "
                         f"{world_size()}")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=axes)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A mesh and the axes its global batch is split over (``batch_axes``):
    ('data',) for data, tensor and pipeline parallelism, ('data', 'model')
    under expert parallelism, whose ranks route distinct rows to each
    other's experts. ``mesh`` None is one process."""

    mesh: DeviceMesh | None = None
    batch_axes: tuple[str, ...] = ("data",)

    def size(self, axis: str) -> int:
        if self.mesh is None or axis not in (self.mesh.mesh_dim_names or ()):
            return 1
        return self.mesh.size(self.mesh.mesh_dim_names.index(axis))

    def coordinate(self, axis: str) -> int:
        if self.mesh is None or axis not in (self.mesh.mesh_dim_names or ()):
            return 0
        return self.mesh.get_local_rank(axis)

    @property
    def n_data(self) -> int:
        return self.size("data")

    @property
    def n_batch(self) -> int:
        """How many row shares the global batch is cut into."""
        return math.prod(self.size(a) for a in self.batch_axes)

    @property
    def batch_index(self) -> int:
        """This rank's share, row-major over ``batch_axes``."""
        i = 0
        for a in self.batch_axes:
            i = i * self.size(a) + self.coordinate(a)
        return i

    def group(self, axis: str) -> dist.ProcessGroup | None:
        """The group of ``axis`` through this rank (None when it has one rank)."""
        if self.size(axis) == 1:
            return None
        return self.mesh.get_group(axis)

    @property
    def batch_group(self) -> dist.ProcessGroup | None:
        """The ranks whose rows make up the global batch (BatchNorm
        statistics, the MoE aux loss, metrics): None on one share."""
        if self.n_batch == 1:
            return None
        if len(self.batch_axes) == 1:
            return self.group(self.batch_axes[0])
        if self.n_batch != self.mesh.size():
            raise ValueError("batch axes must be one axis or the whole mesh")
        return dist.group.WORLD

    def pad_batch(self, n: int) -> int:
        """Round a global batch size up to a multiple of the row shares."""
        d = self.n_batch
        return -(-n // d) * d

    def rows(self, n: int) -> tuple[int, int]:
        """(lo, hi): this rank's rows of a global batch of ``n``."""
        if n % self.n_batch:
            raise ValueError(f"global batch {n} is not divisible by the {self.n_batch} "
                             f"row shares of axes {self.batch_axes}")
        b = n // self.n_batch
        return self.batch_index * b, (self.batch_index + 1) * b


def shard_batch(batch: Any, plan: MeshPlan) -> Any:
    """This rank's rows of every array or tensor in ``batch`` (a dict, a
    sequence or one array)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, plan) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, plan) for v in batch)
    lo, hi = plan.rows(len(batch))
    return batch[lo:hi]


@torch.no_grad()
def replicate(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup | None = None) -> None:
    """Broadcast ``tensors`` in place from the group's first rank."""
    if not dist.is_initialized():
        return
    src = dist.get_global_rank(group, 0) if group is not None else 0
    for t in tensors:
        dist.broadcast(t, src, group=group)


def broadcast_object(obj: Any, group: dist.ProcessGroup | None = None) -> Any:
    """The group's first rank's ``obj`` on every rank of ``group``
    (pickled); ``obj`` itself in a process that has joined no group."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    src = dist.get_global_rank(group, 0) if group is not None else 0
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def gather_objects(obj: Any, group: dist.ProcessGroup | None = None) -> list:
    """Every rank's ``obj`` of ``group`` in rank order, on every rank."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


# --------------------------------------------------------------------------- #
# The launcher
# --------------------------------------------------------------------------- #
def _worker(fn: Callable, rank: int, n: int, init_method: str, backend: str | None,
            device_type: str, device_id: int, args: tuple, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(device_id),
                      LOCAL_WORLD_SIZE=str(n))
    try:
        init_distributed(backend, device_type=device_type, rank=rank, world_size=n,
                         init_method=init_method)
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:   # reported to the parent, then re-raised: the rank fails
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n: int, *args, backend: str | None = None, device_type: str = "cpu",
          device_ids: Sequence[int] | None = None, timeout_s: float = 900,
          rendezvous_dir: str | Path | None = None) -> list:
    """Run ``fn(*args)`` on ``n`` ranks, each in a fresh process that has
    joined the group (``init_distributed``), and return their results by
    rank. ``fn`` and ``args`` are pickled (``fn`` by import path), and so
    are the results: return numpy arrays or Python values. ``device_ids``
    (CUDA): rank r's ``LOCAL_RANK`` (default r; [0, 0] puts two ranks on
    one card). A rank that raises, or a run past ``timeout_s``, ends every
    rank and raises ``RuntimeError`` with the first traceback."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = Path(tempfile.mkdtemp(prefix="rdzv-", dir=rendezvous_dir))
    init_method = f"file://{tmp / 'store'}"
    ids = list(device_ids) if device_ids is not None else list(range(n))
    procs = [ctx.Process(target=_worker, args=(fn, r, n, init_method, backend, device_type,
                                               ids[r], args, results), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    error = None
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < n and error is None:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    error = f"ranks did not finish within {timeout_s} s"
                elif any(p.exitcode not in (None, 0) for p in procs) and results.empty():
                    time.sleep(1.0)   # a last message may still be in flight
                    if results.empty():
                        codes = [p.exitcode for p in procs]
                        error = f"a rank exited without a result (exit codes {codes})"
                continue
            if ok:
                out[rank] = value
            else:
                error = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs:
            p.join(timeout=0 if error else max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    if error is not None:
        raise RuntimeError(error)
    return [out[r] for r in range(n)]
