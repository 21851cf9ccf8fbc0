"""The multi-device layer of the port (K6): the mesh, the sharded-strip
wavelet and the tile-parallel transform (``mesh``), and the distributed
encode, decode and frame entry points (``distributed``)."""

from .distributed import compress_distributed, compress_frames, decompress_distributed
from .mesh import Mesh, make_mesh, make_sharded_strip_dwt, make_sharded_transform

__all__ = [
    "Mesh",
    "compress_distributed",
    "compress_frames",
    "decompress_distributed",
    "make_mesh",
    "make_sharded_strip_dwt",
    "make_sharded_transform",
]
