"""
Runtime helpers for marex_tpu_torch.

The port of ``marex_tpu/helper.py``: the reference's Dask-cluster helpers
(``configure_dask``, ``start_local_cluster``, ``start_distributed_cluster``)
kept as API-compatible shims over the PyTorch runtime, the device inventory
from ``torch.cuda``, checkpoints of Fields to zarr stores (``io.zarr_lite``),
a memory snapshot, a device health check and a retry wrapper for a stage
that fails on the device. Nothing here falls back to the CPU in place of
the card: a health check without a CUDA device reports failure.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from .core.field import Field, FieldSet
from .exceptions import ConfigurationError, DeviceError
from .logging_config import get_logger

logger = get_logger(__name__)

# the reference's runtime defaults, returned by ``configure_dask`` under the
# reference's key names; only the matmul precision has an effect (through
# ``torch.set_float32_matmul_precision``): the others are kept for parity
DEFAULT_RUNTIME_CONFIG: Dict[str, Any] = {
    "jax.transfer_guard": "allow",
    "jax.default_matmul_precision": "default",
    "host.memory_fraction_warn": 0.9,
}

# the reference's JAX precision names, as torch's float32 matmul precisions
_MATMUL_PRECISION = {"highest": "highest", "float32": "highest", "high": "high", "tensorfloat32": "high",
                     "bfloat16_3x": "high", "bfloat16": "medium", "fastest": "medium"}

@dataclass
class ClusterInfo:
    """Description of the active accelerator 'cluster' (device inventory)."""

    backend: str
    n_devices: int
    n_local_devices: int
    device_kind: str
    process_index: int = 0
    n_processes: int = 1
    coords: Optional[list] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def __str__(self) -> str:  # pragma: no cover
        return (
            f"ClusterInfo(backend={self.backend}, devices={self.n_devices} "
            f"({self.device_kind}), processes={self.n_processes})"
        )

    # Dask-client-compatible no-ops so pipeline scripts keep working
    def close(self) -> None:
        pass

    def restart(self) -> None:
        pass


def configure_dask(config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """
    API-compatible shim for the reference's ``configure_dask``: applies the
    runtime configuration and returns the effective config. Only the matmul
    precision has an effect (other than ``"default"``, it goes to
    ``torch.set_float32_matmul_precision``); any other key set away from its
    default is returned as given, with a warning that it changes nothing.
    """
    cfg = dict(DEFAULT_RUNTIME_CONFIG)
    if config:
        cfg.update(config)
    inert = sorted(k for k, v in cfg.items()
                   if k != "jax.default_matmul_precision" and v != DEFAULT_RUNTIME_CONFIG.get(k, object()))
    if inert:
        logger.warning(f"configure_dask: {inert} have no effect on the PyTorch runtime; only "
                       "'jax.default_matmul_precision' is applied")
    precision = cfg.get("jax.default_matmul_precision", "default")
    if precision != "default":
        torch.set_float32_matmul_precision(_MATMUL_PRECISION.get(str(precision), str(precision)))
    logger.debug(f"Runtime configured: {cfg}")
    return cfg


configure_devices = configure_dask


def get_cluster_info(client: Optional[ClusterInfo] = None) -> ClusterInfo:
    """Inventory of the CUDA devices this process sees (none: backend "cpu"),
    with this process's rank and the number of processes of the
    ``torch.distributed`` world (0 and 1 without one)."""
    import torch.distributed as dist

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    joined = dist.is_available() and dist.is_initialized()
    info = ClusterInfo(
        backend="cuda" if n else "cpu",
        n_devices=n,
        n_local_devices=n,
        device_kind=torch.cuda.get_device_name(0) if n else "none",
        process_index=dist.get_rank() if joined else 0,
        n_processes=dist.get_world_size() if joined else 1,
        coords=list(range(n)),
        extra={"process_group_backend": dist.get_backend()} if joined else {},
    )
    logger.info(str(info))
    return info


def start_local_cluster(
    n_workers: Optional[int] = None,
    threads_per_worker: int = 1,
    memory_limit: Optional[str] = None,
    **kwargs: Any,
) -> ClusterInfo:
    """
    Single-process runtime startup (the reference's local cluster): there is
    no scheduler to start, so this applies the default configuration and
    returns the device inventory. The worker arguments are accepted for
    compatibility; the run is one process.
    """
    configure_dask()
    return get_cluster_info()


def start_distributed_cluster(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    **kwargs: Any,
) -> ClusterInfo:
    """
    Multi-process startup, one process a device: joins this process to a
    ``torch.distributed`` world (``init_process_group`` over TCP at
    ``coordinator_address``, ``host:port``). The arguments default to the
    reference's ``COORDINATOR_ADDRESS`` variable, then to ``torchrun``'s
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, so a script
    run by ``torchrun --nproc_per_node=N`` needs none. The backend is
    ``nccl`` (``gloo`` only when asked); before NCCL starts, the process
    takes the CUDA device ``LOCAL_RANK``. With no argument and none of those
    variables nothing is initialised and the run is one process, as in the
    reference. ``kwargs`` go to ``init_process_group`` (``timeout=``, ...).
    """
    import torch.distributed as dist

    env = os.environ
    address = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if address is None and "MASTER_ADDR" in env:
        address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if address is None and num_processes is None:
        logger.info("No coordinator address or world size given: running as one process")
    elif dist.is_initialized():
        logger.warning("torch.distributed is already initialised: start_distributed_cluster leaves it as it is")
    else:
        if address is None or num_processes is None or process_id is None:
            raise ConfigurationError(
                "start_distributed_cluster needs the coordinator address, the number of processes and this process's id",
                suggestions=["Launch with torchrun, which sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK",
                             "Or pass coordinator_address='host:port', num_processes and process_id"],
                context={"coordinator_address": address, "num_processes": num_processes, "process_id": process_id},
            )
        backend = backend or "nccl"
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise DeviceError(
                    "The nccl backend needs a CUDA device",
                    suggestions=["Run on a machine with a GPU", "Pass backend='gloo' for a world on the CPU"],
                )
            torch.cuda.set_device(int(env.get("LOCAL_RANK", int(process_id) % torch.cuda.device_count())))
        dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=int(num_processes),
                                rank=int(process_id), **kwargs)
        logger.info(f"torch.distributed initialised ({backend}): process {dist.get_rank()} of {dist.get_world_size()}")
    configure_dask()
    return get_cluster_info()


def checkpoint_to_zarr(
    data: Any,
    name: str = "checkpoint",
    timedim: str = "time",
    temp_dir: Optional[str] = None,
) -> Any:
    """Write a Field/FieldSet to a zarr store under ``temp_dir`` (a new
    temporary directory without one) and reload it from there."""
    import tempfile

    from .io.zarr_lite import open_zarr, to_zarr

    if temp_dir is not None:
        base = temp_dir
        os.makedirs(base, exist_ok=True)
    else:
        base = tempfile.mkdtemp(prefix="marex_tpu_ckpt_")
    path = os.path.join(base, f"marex_tpu_{name}.zarr")
    to_zarr(data, path, mode="w")
    reloaded = open_zarr(path)
    if isinstance(data, Field) and isinstance(reloaded, FieldSet):
        return reloaded[data.name or "data"]
    return reloaded


def fix_dask_tuple_array(da: Any) -> Any:
    """Compatibility no-op (there is no task graph here)."""
    return da


def memory_summary() -> Dict[str, float]:
    """Host (through psutil, when installed) and CUDA device memory in MB."""
    out: Dict[str, float] = {}
    try:
        import psutil
    except ImportError:
        psutil = None
    if psutil is not None:
        out["host_rss_mb"] = psutil.Process().memory_info().rss / 2**20
        out["host_available_mb"] = psutil.virtual_memory().available / 2**20
    if torch.cuda.is_available():
        for d in range(torch.cuda.device_count()):
            out[f"device{d}_in_use_mb"] = torch.cuda.memory_allocated(d) / 2**20
    return out


def check_device_health(raise_on_error: bool = True) -> Dict[str, Any]:
    """
    Run a tiny sum on every CUDA device. Returns ``{"devices": [...], "ok":
    bool}`` with each device's status and error. With no CUDA device the
    report is not ok (the CPU is never probed in the card's place); with
    ``raise_on_error`` a failure raises :class:`DeviceError`.
    """
    report: Dict[str, Any] = {"devices": [], "ok": True}
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        report["ok"] = False
        report["error"] = "no CUDA device (torch.cuda.is_available() is False)"
    for d in range(n):
        entry: Dict[str, Any] = {"id": d, "kind": torch.cuda.get_device_name(d), "ok": True}
        try:
            val = float((torch.arange(8, dtype=torch.float32, device=f"cuda:{d}") * 2.0).sum())
            if val != 56.0:
                entry["ok"] = False
                entry["error"] = f"probe returned {val}, expected 56.0"
        except RuntimeError as e:  # the CUDA runtime's errors (torch.AcceleratorError is one)
            entry["ok"] = False
            entry["error"] = f"{type(e).__name__}: {e}"
        report["devices"].append(entry)
        report["ok"] &= entry["ok"]
    if not report["ok"]:
        bad = [e for e in report["devices"] if not e["ok"]]
        logger.error(f"Device health check failed: {report.get('error', bad)}")
        if raise_on_error:
            raise DeviceError(
                "Accelerator device health check failed",
                details=report.get("error") or f"{len(bad)} of {n} CUDA devices failed the compute probe",
                suggestions=[
                    "Restart the process to reinitialise the failed device",
                    "Check that a CUDA device is visible (nvidia-smi, CUDA_VISIBLE_DEVICES)",
                ],
                context={"failed_devices": bad, "n_devices": n},
            )
    return report


def _default_retry_exceptions() -> tuple:
    """DeviceError, OSError and the CUDA runtime's own error class, where
    this torch has one (not every RuntimeError)."""
    excs = [DeviceError, OSError]
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        excs.append(accel)
    return tuple(excs)


def run_with_retries(
    fn,
    *args,
    retries: int = 2,
    retry_exceptions: Optional[tuple] = None,
    on_retry=None,
    health_check: bool = True,
    **kwargs,
):
    """
    ``fn(*args, **kwargs)``, run again after a device or runtime failure (up
    to ``retries`` more times). Between attempts the CUDA caching allocator
    is emptied and, with ``health_check``, the devices are checked, so a dead
    card fails fast with :class:`DeviceError`; ``on_retry(attempt, exc)``
    runs before each retry (e.g. to reload a stage checkpoint).
    """
    if retry_exceptions is None:
        retry_exceptions = _default_retry_exceptions()
    last: Optional[BaseException] = None
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except retry_exceptions as e:  # type: ignore[misc]
            last = e
            if attempt >= retries:
                break
            logger.warning(
                f"Stage '{getattr(fn, '__name__', 'fn')}' failed on attempt {attempt + 1}/{retries + 1} "
                f"({type(e).__name__}: {e}); retrying"
            )
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            if health_check:
                check_device_health(raise_on_error=True)
            if on_retry is not None:
                on_retry(attempt, e)
    assert last is not None
    raise last
