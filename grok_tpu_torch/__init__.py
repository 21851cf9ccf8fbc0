"""grok_tpu_torch — the PyTorch / CUDA port of grok_tpu for NVIDIA Hopper.

This slice ports the Part-1 lossless encode: DC shift + RCT + 5/3 DWT,
codeblock gather, EBCOT context modelling and MQ coding on the GPU in
hand-written CUDA kernels (``csrc/``), T2 and markers on the host. The
package imports torch and numpy only; grok_tpu is its reference in the
tests, never a dependency.

    import grok_tpu_torch as gt
    stream = gt.compress(gt.Image.from_array(arr), gt.CompressParams())

``compress`` runs on the current CUDA device; ``device="cpu"`` runs the
kernels' plain torch versions instead (what the CPU tests do).
"""

from .codestream.compress import compress
from .core.errors import ParameterError, UnsupportedFeatureError
from .core.image import Component, Image
from .core.params import ColorSpace, CompressParams, ProgressionOrder, QuantStyle
from .kernels import launch_counts, reset_launch_counts

__all__ = [
    "ColorSpace",
    "Component",
    "CompressParams",
    "Image",
    "ParameterError",
    "ProgressionOrder",
    "QuantStyle",
    "UnsupportedFeatureError",
    "compress",
    "launch_counts",
    "reset_launch_counts",
]
