"""grok_tpu_torch — the PyTorch / CUDA port of grok_tpu for NVIDIA Hopper.

Six slices are ported. The Part-1 lossless encode: DC shift + RCT + 5/3
DWT, codeblock gather, EBCOT context modelling and MQ coding. Its decode:
EBCOT/MQ decoding of every codeblock style, codeblock scatter, the inverse
5/3 + RCT, with ``DecompressParams(max_layers=k)`` for a layer-limited
decode. The HTJ2K lossless encode and decode (``ht=True``): the same
transform and gather, the HT cleanup coder and decoder. The 9/7 + ICT
encode and decode (``irreversible=True``). Quality layers with PCRD rate
control (``num_layers``, ``layer_rates``, ``layer_psnrs``): per-pass
distortions and hull slopes on the device, the threshold search and its
packet simulations on the host. The Part-2 array MCT (``mct_matrix``,
on the 9/7 path) and component ROI (``roi_comp``/``roi_shift``), encode
and decode. Device work runs in hand-written CUDA
kernels (``csrc/``); T2 and markers run on the host. The package imports
torch and numpy only; grok_tpu is its reference in the tests, never a
dependency.

    import grok_tpu_torch as gt
    stream = gt.compress(gt.Image.from_array(arr), gt.CompressParams(ht=True))
    lossy = gt.compress(gt.Image.from_array(arr),
                        gt.CompressParams(irreversible=True, layer_rates=[8]))
    image = gt.decompress(stream)

``compress`` and ``decompress`` run on the current CUDA device;
``device="cpu"`` runs the kernels' plain versions instead (what the CPU
tests do). The multi-device layer (``parallel/``, K6) deals tiles or frames
to the shards of a mesh, a list of devices (``make_mesh()``: every card;
``make_mesh(4, device="cuda:0")``: four shards on one card;
``make_mesh(8, device="cpu")``: the plain versions):
``compress_distributed``, ``decompress_distributed`` and
``compress_frames`` give ``compress``'s streams and ``decompress``'s
planes; ``make_sharded_strip_dwt`` is the Y-sharded strip wavelet with
one-row halos and ``make_sharded_transform`` the tile-parallel transform
with block statistics.
"""

from .codestream.compress import compress
from .codestream.decompress import decompress
from .core.errors import ParameterError, UnsupportedFeatureError
from .core.image import Component, Image
from .core.params import (ColorSpace, CompressParams, DecompressParams, ProgressionOrder,
                          QuantStyle)
from .kernels import launch_counts, reset_launch_counts
from .parallel import (Mesh, compress_distributed, compress_frames, decompress_distributed,
                       make_mesh, make_sharded_strip_dwt, make_sharded_transform)

__all__ = [
    "ColorSpace",
    "Mesh",
    "Component",
    "CompressParams",
    "DecompressParams",
    "Image",
    "ParameterError",
    "ProgressionOrder",
    "QuantStyle",
    "UnsupportedFeatureError",
    "compress",
    "compress_distributed",
    "compress_frames",
    "decompress",
    "decompress_distributed",
    "launch_counts",
    "make_mesh",
    "make_sharded_strip_dwt",
    "make_sharded_transform",
    "reset_launch_counts",
]
