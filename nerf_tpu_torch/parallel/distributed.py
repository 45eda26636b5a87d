"""Process groups: one process (a rank) per card, joined by torch.distributed.

Counterpart of nerf_tpu/parallel/distributed.py. nerf_tpu brings up a
``jax.distributed`` process group and lets one program span every device;
the port runs one process per card and joins them in a torch.distributed
group, which stands in for the ``'data'`` mesh axis (parallel/mesh.py).
Rank r drives ``cuda:r`` on one host (torchrun's ``LOCAL_RANK`` where it is
set). The backend follows from the device: NCCL when each rank has a card
of its own, gloo on the CPU; another one only when the caller names it.

- ``initialize`` joins the group that the config (``coordinator_address``,
  ``num_processes``, ``process_id``) or torchrun's environment describes;
  a single process joins none.
- ``launch`` spawns n ranks on this host and returns their results.
- ``host_shard_slice`` is the rank's rows of a global batch axis, and
  ``barrier`` waits for every rank (JAX's ``sync_global_devices``).
- ``capturable`` says whether a backend's collectives can go into a CUDA
  graph (the fused loop over ranks), and ``connect`` makes a group's
  communicator before the first capture.

nerf_tpu's ``global_batch_from_host_shards`` has no counterpart: it
assembles one global array from every host's shard, and here each rank
holds only its own rows of a batch; the step all-reduces gradients, never
batches.
"""

from __future__ import annotations

import io
import os
import queue
import socket
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from nerf_tpu_torch.device import DeviceLike, resolve_device

# seconds a rank that failed leaves the others to stop on their own before
# they are terminated (a peer that waits in a collective never returns)
_GRACE_S = 5.0


def default_backend(device: DeviceLike) -> str:
    """gloo for CPU ranks, NCCL for ranks on cards."""
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def in_group() -> bool:
    """Whether this process has joined a process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The ranks in the process group; 1 without one."""
    return dist.get_world_size() if in_group() else 1


def rank() -> int:
    return dist.get_rank() if in_group() else 0


def local_rank() -> int:
    """The rank among this host's ranks: torchrun's ``LOCAL_RANK`` (which
    ``launch`` sets too), else the rank, as on a single host."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def rank_device(device: DeviceLike = None) -> torch.device:
    """The rank's device: ``cuda`` without an index is the rank's own card,
    ``cuda:<local rank>``; a device with an index, or the CPU, stays as
    given (ranks that share one card name it)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    return dev


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: DeviceLike = None,
) -> bool:
    """Join the process group; returns whether there is one.

    The three arguments (the config's fields; ``coordinator_address`` as
    ``host:port``) win; else torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``. A single process (neither names more than
    one rank) joins nothing. ``backend`` defaults to the device's
    (``default_backend``); the rank's card is made current first. A failed
    join raises."""
    if dist.is_initialized():
        return True
    if coordinator_address or (num_processes is not None and num_processes > 1):
        if not coordinator_address or num_processes is None or process_id is None:
            raise ValueError("a process group needs coordinator_address, num_processes and "
                             f"process_id; got {coordinator_address!r}, {num_processes!r}, "
                             f"{process_id!r}")
        init_method = f"tcp://{coordinator_address}"
        size, index = int(num_processes), int(process_id)
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1 and "MASTER_ADDR" in os.environ:
        init_method = "env://"
        size, index = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = dev.index if dev.index is not None else int(os.environ.get("LOCAL_RANK", index))
        torch.cuda.set_device(local)
    dist.init_process_group(backend or default_backend(dev), init_method=init_method,
                            world_size=size, rank=index)
    return True


def shard_slice(n_total: int, index: int, size: int) -> slice:
    """Rank ``index`` of ``size``'s contiguous rows of a length-n_total axis;
    raises on a remainder (dropping it would shrink the global batch)."""
    if n_total % size != 0:
        raise ValueError(f"global batch axis ({n_total}) must divide evenly over {size} ranks")
    per = n_total // size
    return slice(index * per, (index + 1) * per)


def host_shard_slice(n_total: int) -> slice:
    """This rank's contiguous shard of a length-n_total global batch axis."""
    return shard_slice(n_total, rank(), world_size())


def capturable(backend: str) -> bool:
    """Whether a CUDA graph can hold the collectives of a ``backend`` group
    (train/graph.py's chunks over ranks): NCCL's can, its kernels queued on
    a stream that the capture joins; gloo's cannot, its all-reduce of a
    card's tensor goes through the host."""
    return backend == "nccl"


def connect(group, device: torch.device) -> None:
    """Make the group's communicator on ``device`` now, by one all-reduce
    waited for: NCCL makes it at the group's first collective on the card,
    and that must not be one inside a graph's capture."""
    probe = torch.zeros(1, device=device)
    dist.all_reduce(probe, group=group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def barrier(group=None) -> None:
    """Wait until every rank of ``group`` (the whole group by default) is here."""
    if world_size() == 1:
        return
    if dist.get_backend(group) == "nccl":
        dist.barrier(group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, index: int, n: int, port: int, device: str, backend: str,
               args: Sequence[Any], results) -> None:
    """A spawned rank: join the group, run ``fn(rank device, *args)`` and
    send back its result (``torch.save`` bytes) or its traceback."""
    os.environ["LOCAL_RANK"] = str(index)
    try:
        initialize(f"localhost:{port}", n, index, backend=backend, device=device)
        out = fn(rank_device(device), *args)
        buf = io.BytesIO()
        torch.save(out, buf)
        results.put((index, True, buf.getvalue()))
    except BaseException:
        results.put((index, False, traceback.format_exc()))
        raise
    dist.destroy_process_group()


def launch(fn: Callable[..., Any], n: int, device: DeviceLike = None,
           backend: Optional[str] = None, args: Sequence[Any] = ()) -> List[Any]:
    """Run ``fn(device_of_rank, *args)`` on ``n`` ranks of this host, each a
    process started by torch.multiprocessing's ``spawn`` in one group on a
    free local port; returns their results in rank order, loaded on the CPU.

    ``device`` ``cuda`` gives each rank its own card (NCCL); ``cuda:i``
    puts every rank on card i, which needs ``backend="gloo"``; ``cpu`` runs
    gloo ranks on the CPU. ``fn`` and ``args`` must pickle. When a rank
    fails, the others are stopped and its traceback is raised."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    if dev.type == "cuda":
        if backend == "nccl" and dev.index is not None and n > 1:
            raise ValueError(f"NCCL needs a card per rank; {n} ranks on {dev} need backend='gloo'")
        if dev.index is None and n > torch.cuda.device_count():
            raise ValueError(f"{n} ranks, one per card, but {torch.cuda.device_count()} "
                             "cards are visible")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, i, n, port, str(dev), backend, tuple(args), results))
             for i in range(n)]
    for p in procs:
        p.start()
    done, failure = {}, None
    try:
        while len(done) < n and failure is None:
            try:
                index, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                silent = [i for i, p in enumerate(procs) if p.exitcode is not None and i not in done]
                if not silent:
                    continue
                try:  # its last word may still be in the pipe
                    index, ok, payload = results.get(timeout=_GRACE_S)
                except queue.Empty:
                    i = silent[0]
                    failure = (i, f"exited with code {procs[i].exitcode} and sent no result")
                    break
            if ok:
                done[index] = payload
            else:
                failure = (index, payload)
    finally:
        for p in procs:
            p.join(timeout=_GRACE_S if failure is not None or len(done) < n else None)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    if failure is not None:
        raise RuntimeError(f"rank {failure[0]} of {n} failed:\n{failure[1]}")
    bad = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return [torch.load(io.BytesIO(done[i]), map_location="cpu", weights_only=False)
            for i in range(n)]
