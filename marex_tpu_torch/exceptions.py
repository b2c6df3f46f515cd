"""
Exception hierarchy for marex_tpu_torch.

A copy of ``marex_tpu/exceptions.py`` (the module is backend-neutral): a rich
base exception carrying structured ``details`` / ``suggestions`` /
``context`` payloads plus typed subclasses and factory helpers, so callers
catch the same classes from either package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class MarExError(Exception):
    """
    Base exception for all marex_tpu_torch errors.

    Parameters
    ----------
    message : str
        Primary human-readable error message.
    details : str, optional
        Longer explanation of what went wrong.
    suggestions : list of str, optional
        Actionable hints for resolving the problem.
    error_code : str, optional
        Stable machine-readable identifier.
    context : dict, optional
        Structured payload with the offending values.
    """

    default_error_code = "MAREX_ERROR"

    def __init__(
        self,
        message: str,
        details: Optional[str] = None,
        suggestions: Optional[List[str]] = None,
        error_code: Optional[str] = None,
        context: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.message = message
        self.details = details
        self.suggestions = list(suggestions) if suggestions else []
        self.error_code = error_code or self.default_error_code
        self.context = dict(context) if context else {}
        super().__init__(self._format())

    def _format(self) -> str:
        parts = [self.message]
        if self.details:
            parts.append(f"Details: {self.details}")
        if self.suggestions:
            tips = "\n".join(f"  - {s}" for s in self.suggestions)
            parts.append(f"Suggestions:\n{tips}")
        if self.context:
            ctx = ", ".join(f"{k}={v!r}" for k, v in self.context.items())
            parts.append(f"Context: {ctx}")
        return "\n".join(parts)

    def add_suggestion(self, suggestion: str) -> None:
        """Append a remediation suggestion after creation (reference
        marEx/exceptions.py:75-77); the formatted message is refreshed."""
        self.suggestions.append(suggestion)
        super().__init__(self._format())

    def add_context(self, key: str, value: Any) -> None:
        """Attach one debugging key/value after creation (reference
        marEx/exceptions.py:79-81); the formatted message is refreshed."""
        self.context[key] = value
        super().__init__(self._format())

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{type(self).__name__}({self.message!r}, error_code={self.error_code!r})"

    def to_dict(self) -> Dict[str, Any]:
        """Serialise the error to a plain dictionary (for logging/telemetry)."""
        return {
            "type": type(self).__name__,
            "message": self.message,
            "details": self.details,
            "suggestions": self.suggestions,
            "error_code": self.error_code,
            "context": self.context,
        }


class DataValidationError(MarExError):
    """Invalid input data (shape, dtype, NaN policy, missing dims/coords)."""

    default_error_code = "DATA_VALIDATION_ERROR"

    def __init__(self, message: str, *args: Any, data_info: Optional[Dict[str, Any]] = None, **kwargs: Any) -> None:
        if data_info:
            ctx = kwargs.pop("context", None) or {}
            ctx.update(data_info)
            kwargs["context"] = ctx
        self.data_info = dict(data_info) if data_info else {}
        super().__init__(message, *args, **kwargs)


class CoordinateError(MarExError):
    """Problems with coordinate systems, units, or ranges."""

    default_error_code = "COORDINATE_ERROR"


class ProcessingError(MarExError):
    """Failure inside a processing stage (detect/track compute)."""

    default_error_code = "PROCESSING_ERROR"


class ConfigurationError(MarExError):
    """Invalid or inconsistent user-supplied parameters."""

    default_error_code = "CONFIGURATION_ERROR"


class DependencyError(MarExError):
    """A required optional dependency is missing."""

    default_error_code = "DEPENDENCY_ERROR"


class TrackingError(MarExError):
    """Failure inside the event tracker."""

    default_error_code = "TRACKING_ERROR"

    def __init__(self, message: str, *args: Any, details: Any = None, **kwargs: Any) -> None:
        # The tracker sometimes passes a structured dict as ``details``.
        if isinstance(details, dict):
            ctx = kwargs.pop("context", None) or {}
            ctx.update(details)
            kwargs["context"] = ctx
            details = None
        super().__init__(message, details, *args, **kwargs)


class VisualisationError(MarExError):
    """Failure inside the plotX visualisation subsystem."""

    default_error_code = "VISUALISATION_ERROR"


class DeviceError(MarExError):
    """Accelerator placement, kernel build or kernel launch failure."""

    default_error_code = "DEVICE_ERROR"


# ----------------------------------------------------------------------------
# Factory helpers
# ----------------------------------------------------------------------------


def create_data_validation_error(
    message: str,
    details: Optional[str] = None,
    suggestions: Optional[List[str]] = None,
    data_info: Optional[Dict[str, Any]] = None,
) -> DataValidationError:
    """Build a :class:`DataValidationError` with structured data info."""
    return DataValidationError(message, details=details, suggestions=suggestions, data_info=data_info)


def create_coordinate_error(
    message: str,
    details: Optional[str] = None,
    suggestions: Optional[List[str]] = None,
    context: Optional[Dict[str, Any]] = None,
) -> CoordinateError:
    """Build a :class:`CoordinateError`."""
    return CoordinateError(message, details=details, suggestions=suggestions, context=context)


def create_processing_error(
    message: str,
    details: Optional[str] = None,
    suggestions: Optional[List[str]] = None,
    context: Optional[Dict[str, Any]] = None,
) -> ProcessingError:
    """Build a :class:`ProcessingError`."""
    return ProcessingError(message, details=details, suggestions=suggestions, context=context)


def create_tracking_error(
    message: str,
    details: Optional[str] = None,
    suggestions: Optional[List[str]] = None,
    context: Optional[Dict[str, Any]] = None,
) -> TrackingError:
    """Build a :class:`TrackingError`."""
    return TrackingError(message, details=details, suggestions=suggestions, context=context)


def wrap_exception(
    exc: BaseException,
    message: Optional[str] = None,
    error_class: type = ProcessingError,
    suggestions: Optional[List[str]] = None,
) -> MarExError:
    """
    Wrap an arbitrary exception into the MarEx hierarchy, preserving the cause.

    Parameters
    ----------
    exc : BaseException
        Original exception.
    message : str, optional
        Override message; defaults to the original message.
    error_class : type, default=ProcessingError
        MarExError subclass to create.
    suggestions : list of str, optional
        Actionable hints.
    """
    if isinstance(exc, MarExError) and message is None:
        return exc
    msg = message or f"{type(exc).__name__}: {exc}"
    wrapped = error_class(
        msg,
        details=str(exc) if message else None,
        suggestions=suggestions,
        context={"original_type": type(exc).__name__},
    )
    wrapped.__cause__ = exc
    return wrapped
