"""Typed codec exceptions (counterpart of grok_tpu/core/errors.py, the
encoder's share)."""


class GrokTpuError(Exception):
    """Base class for all codec errors."""


class UnsupportedFeatureError(GrokTpuError):
    """Standard-legal feature this build does not implement yet."""


class ParameterError(GrokTpuError):
    """Invalid user-supplied coding parameters."""
