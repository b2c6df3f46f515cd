"""Device operations of marex_tpu_torch (PyTorch, and the CUDA kernels in ``min_stencil``)."""

from . import label, min_stencil, morphology, pipeline, quantile  # noqa: F401

__all__ = ["label", "min_stencil", "morphology", "pipeline", "quantile"]
