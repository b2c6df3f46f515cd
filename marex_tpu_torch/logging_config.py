"""
Logging & observability for marex_tpu_torch.

The same operational surface as ``marex_tpu.logging_config``: env-var
controlled verbosity (``MAREX_LOG_LEVEL/LOG_FILE/VERBOSE/QUIET``), three
verbosity modes with distinct formats, a rotating file handler, timing
context managers that also snapshot process memory, progress helpers, and a
function-call decorator. Device telemetry reads ``torch.cuda.memory_stats()``
and the trace wrapper is ``torch.profiler``.
"""

from __future__ import annotations

import functools
import logging
import logging.handlers
import os
import sys
import time
from contextlib import contextmanager
from typing import Any, Callable, Iterator, Optional

_PACKAGE_LOGGER_NAME = "marex_tpu_torch"

# Module-level verbosity state: "normal" | "verbose" | "quiet"
_verbosity_mode = "normal"
_configured = False

_FORMATS = {
    "quiet": "%(levelname)s: %(message)s",
    "normal": "%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    "verbose": "%(asctime)s - %(name)s - %(levelname)s - [%(filename)s:%(lineno)d] - %(message)s",
}

_LEVELS = {
    "quiet": logging.WARNING,
    "normal": logging.INFO,
    "verbose": logging.DEBUG,
}


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes", "on")


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """Return a logger in the marex_tpu_torch hierarchy."""
    if name is None or name == _PACKAGE_LOGGER_NAME:
        return logging.getLogger(_PACKAGE_LOGGER_NAME)
    if name.startswith(_PACKAGE_LOGGER_NAME):
        return logging.getLogger(name)
    return logging.getLogger(f"{_PACKAGE_LOGGER_NAME}.{name}")


def configure_logging(
    verbose: Optional[bool] = None,
    quiet: Optional[bool] = None,
    level: Optional[int] = None,
    log_file: Optional[str] = None,
    max_file_size_mb: int = 50,
    backup_count: int = 3,
) -> logging.Logger:
    """
    Configure package-wide logging.

    Resolution order mirrors the reference behaviour: explicit arguments win,
    then environment variables ``MAREX_VERBOSE`` / ``MAREX_QUIET`` /
    ``MAREX_LOG_LEVEL`` / ``MAREX_LOG_FILE``. ``quiet`` takes precedence over
    ``verbose`` when both are set.
    """
    global _verbosity_mode, _configured

    if verbose is None:
        verbose = _env_flag("MAREX_VERBOSE")
    if quiet is None:
        quiet = _env_flag("MAREX_QUIET")
    if log_file is None:
        log_file = os.environ.get("MAREX_LOG_FILE") or None

    if quiet:
        _verbosity_mode = "quiet"
    elif verbose:
        _verbosity_mode = "verbose"
    else:
        _verbosity_mode = "normal"

    if level is None:
        env_level = os.environ.get("MAREX_LOG_LEVEL")
        if env_level:
            level = getattr(logging, env_level.upper(), None)
        if level is None:
            level = _LEVELS[_verbosity_mode]

    logger = logging.getLogger(_PACKAGE_LOGGER_NAME)
    logger.setLevel(level)

    # Reset handlers so re-configuration is idempotent
    for h in list(logger.handlers):
        logger.removeHandler(h)

    fmt = logging.Formatter(_FORMATS[_verbosity_mode])
    stream = logging.StreamHandler(sys.stderr)
    stream.setFormatter(fmt)
    logger.addHandler(stream)

    if log_file:
        fh = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=max_file_size_mb * 1024 * 1024, backupCount=backup_count
        )
        fh.setFormatter(logging.Formatter(_FORMATS["verbose"]))
        logger.addHandler(fh)

    logger.propagate = False
    _configure_external_loggers()
    _configured = True
    return logger


def set_verbose_mode(verbose: bool = True) -> None:
    """Enable (or, with ``verbose=False``, disable) verbose DEBUG logging.

    Signature matches the reference's ``set_verbose_mode``
    (``marEx/logging_config.py:183-191``).
    """
    configure_logging(verbose=verbose, quiet=False)


def set_quiet_mode(quiet: bool = True) -> None:
    """Enable (or, with ``quiet=False``, disable) quiet WARNING+ logging.

    Signature matches the reference's ``set_quiet_mode``
    (``marEx/logging_config.py:193-201``).
    """
    configure_logging(verbose=False, quiet=quiet)


def set_normal_logging() -> None:
    """Switch to normal (INFO) logging."""
    configure_logging(verbose=False, quiet=False)


def get_verbosity_level() -> str:
    """Return the current verbosity mode string."""
    return _verbosity_mode


def is_verbose_mode() -> bool:
    """True when verbose mode is active."""
    return _verbosity_mode == "verbose"


def is_quiet_mode() -> bool:
    """True when quiet mode is active."""
    return _verbosity_mode == "quiet"


# ----------------------------------------------------------------------------
# Memory / timing instrumentation
# ----------------------------------------------------------------------------


def _host_memory_mb() -> Optional[float]:
    try:
        import psutil

        return psutil.Process().memory_info().rss / (1024.0 * 1024.0)
    except Exception:  # pragma: no cover
        return None


def _device_memory_mb() -> Optional[float]:
    """Sum PyTorch's allocated CUDA bytes across local devices; None when this
    process has not initialised CUDA (telemetry never creates a context)."""
    import torch

    if not torch.cuda.is_initialized():
        return None
    total = 0.0
    for i in range(torch.cuda.device_count()):
        total += torch.cuda.memory_stats(i).get("allocated_bytes.all.current", 0) / (1024.0 * 1024.0)
    return total


def get_memory_usage() -> dict:
    """
    Return current process memory statistics in MB.

    Same keys as the reference's ``get_memory_usage``
    (``marEx/logging_config.py:246-263``): ``rss_mb``, ``vms_mb``,
    ``percent``, ``available_mb``; plus ``device_mb`` (PyTorch's allocated
    CUDA bytes summed over local devices, 0.0 before CUDA is initialised).
    """
    out = {"rss_mb": 0.0, "vms_mb": 0.0, "percent": 0.0, "available_mb": 0.0}
    try:
        import psutil

        process = psutil.Process()
        mem = process.memory_info()
        out["rss_mb"] = mem.rss / 1024 / 1024
        out["vms_mb"] = mem.vms / 1024 / 1024
        out["percent"] = process.memory_percent()
        out["available_mb"] = psutil.virtual_memory().available / 1024 / 1024
    except Exception:  # pragma: no cover - psutil is a hard dep in practice
        pass
    out["device_mb"] = _device_memory_mb() or 0.0
    return out


def log_memory_usage(logger: logging.Logger, label: str = "Memory", level: int = logging.INFO) -> None:
    """Log host RSS and (when available) device memory usage."""
    host = _host_memory_mb()
    dev = _device_memory_mb()
    bits = []
    if host is not None:
        bits.append(f"host={host:.1f} MB")
    if dev is not None:
        bits.append(f"device={dev:.1f} MB")
    if bits:
        logger.log(level, f"{label}: {', '.join(bits)}")


@contextmanager
def log_timing(
    logger: logging.Logger,
    label: str,
    level: int = logging.INFO,
    log_memory: bool = False,
    show_progress: bool = False,
) -> Iterator[None]:
    """
    Context manager timing a pipeline stage (optionally with memory deltas).

    Equivalent role to the reference's ``log_timing``
    (``marEx/logging_config.py:287-340``).
    """
    start = time.perf_counter()
    mem_before = _host_memory_mb() if log_memory else None
    if show_progress and not is_quiet_mode():
        logger.log(level, f"Starting: {label}")
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        msg = f"Completed: {label} in {elapsed:.2f}s"
        if log_memory:
            mem_after = _host_memory_mb()
            if mem_before is not None and mem_after is not None:
                msg += f" (host mem {mem_before:.0f}->{mem_after:.0f} MB)"
        logger.log(level, msg)


def log_function_call(logger: Optional[logging.Logger] = None, level: int = logging.DEBUG) -> Callable:
    """Decorator logging entry/exit and duration of a function call."""

    def decorator(fn: Callable) -> Callable:
        log = logger or get_logger(fn.__module__)

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            log.log(level, f"Calling {fn.__qualname__}")
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                log.log(level, f"Finished {fn.__qualname__} in {time.perf_counter() - t0:.3f}s")

        return wrapper

    return decorator


def log_dask_info(logger: logging.Logger, obj: Any, label: str = "Array") -> None:
    """
    Log shape/dtype information for an array-like object.

    Name kept for API familiarity with the reference's ``log_dask_info``;
    here it reports Field/ndarray metadata (there is no task graph).
    """
    try:
        shape = getattr(obj, "shape", None)
        dtype = getattr(obj, "dtype", None)
        dims = getattr(obj, "dims", None)
        sizes = None
        if dims is not None and shape is not None:
            sizes = dict(zip(dims, shape))
        logger.debug(f"{label}: shape={shape}, dtype={dtype}, dims={sizes or dims}")
    except Exception:  # pragma: no cover
        logger.debug(f"{label}: <unavailable>")


# Alias used in some call sites
log_array_info = log_dask_info


@contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """
    ``torch.profiler`` trace of the enclosed block, written as a Chrome trace
    (viewable in Perfetto) to ``<log_dir>/trace.json``. CUDA activity is
    recorded when this process has initialised CUDA.
    """
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def create_progress_bar(
    total: Optional[int] = None,
    desc: str = "Processing",
    unit: str = "it",
    disable: Optional[bool] = None,
):
    """
    Create a tqdm progress bar when tqdm is importable and mode is not quiet.

    Returns ``None`` when disabled or tqdm is unavailable — call sites must
    guard with ``if pbar:``. Mirrors the reference's ``create_progress_bar``
    (``marEx/logging_config.py:343-375``).
    """
    try:
        from tqdm import tqdm
    except Exception:
        return None
    if disable is None:
        disable = is_quiet_mode()
    if disable:
        return None
    return tqdm(
        total=total,
        desc=desc,
        unit=unit,
        ascii=os.environ.get("TERM") != "xterm-256color",
    )


@contextmanager
def progress_bar(
    total: Optional[int] = None,
    desc: str = "Processing",
    unit: str = "it",
    logger: Optional[logging.Logger] = None,
) -> Iterator[Any]:
    """
    Context manager yielding a progress bar (or ``None``), with a logging
    fallback on close when no bar was shown. Mirrors the reference's
    ``progress_bar`` (``marEx/logging_config.py:379-410``).
    """
    pbar = create_progress_bar(total=total, desc=desc, unit=unit)
    try:
        yield pbar
    finally:
        if pbar is not None:
            pbar.close()
        elif logger is not None and not is_quiet_mode():
            logger.info(f"Completed {desc}")


def log_progress(
    logger: logging.Logger,
    current: int,
    total: int,
    operation: str = "Processing",
    frequency: int = 10,
) -> None:
    """
    Log progress at ``frequency``-percent milestones (and at completion)
    without a progress bar. Mirrors the reference's ``log_progress``
    (``marEx/logging_config.py:413-445``); suppressed in quiet mode.
    """
    if is_quiet_mode() or total <= 0:
        return
    percentage = (current / total) * 100
    if percentage % max(frequency, 1) == 0 or current == total:
        if is_verbose_mode():
            logger.debug(f"{operation}: {current}/{total} ({percentage:.1f}%)")
        else:
            logger.info(f"{operation}: {percentage:.0f}% complete ({current}/{total})")


def setup_logging(*args: Any, **kwargs: Any) -> logging.Logger:
    """Backward-compatible alias for :func:`configure_logging`
    (reference parity: ``marEx/logging_config.py:546-548``)."""
    return configure_logging(*args, **kwargs)


def _configure_external_loggers() -> None:
    """Quieten noisy third-party loggers (reference parity:
    ``marEx/logging_config.py:228-243``, with the Dask names replaced by the
    libraries this runtime actually pulls in)."""
    for name in (
        "matplotlib.font_manager",
        "PIL.PngImagePlugin",
        "asyncio",
        "fsspec",
        "urllib3",
    ):
        logging.getLogger(name).setLevel(logging.ERROR)


class ProgressLogger:
    """
    Minimal progress reporter (tqdm-free), mirroring the role of the
    reference's tqdm helpers (``marEx/logging_config.py:343-445``).
    """

    def __init__(self, logger: logging.Logger, total: int, label: str = "progress", every: int = 10):
        self.logger = logger
        self.total = max(int(total), 1)
        self.label = label
        self.every = max(int(every), 1)
        self.count = 0
        self._t0 = time.perf_counter()

    def update(self, n: int = 1) -> None:
        self.count += n
        if self.count % self.every == 0 or self.count >= self.total:
            pct = 100.0 * self.count / self.total
            rate = self.count / max(time.perf_counter() - self._t0, 1e-9)
            if not is_quiet_mode():
                self.logger.info(f"{self.label}: {self.count}/{self.total} ({pct:.0f}%, {rate:.1f}/s)")


# Configure once at import using env vars (cheap, idempotent)
if not _configured:
    configure_logging()
