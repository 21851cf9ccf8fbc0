"""Typed codec exceptions (counterpart of grok_tpu/core/errors.py)."""


class GrokTpuError(Exception):
    """Base class for all codec errors."""


class UnsupportedFeatureError(GrokTpuError):
    """Standard-legal feature this build does not implement yet."""


class ParameterError(GrokTpuError):
    """Invalid user-supplied coding parameters."""


class CodestreamError(GrokTpuError):
    """Malformed or truncated codestream."""


class InvalidMarkerError(CodestreamError):
    """Unexpected or unknown marker where a specific one is required."""


class CorruptPacketError(CodestreamError):
    """Packet header or body inconsistent with the coding parameters."""
