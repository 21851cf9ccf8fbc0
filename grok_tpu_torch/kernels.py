"""Hand-written CUDA kernels of the port: build, load and launch counts.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper (sm_90a)
into its own shared library with a plain C interface, loaded with ctypes.
The build happens at first use, in ``grok_tpu_torch/build/``, one nvcc
process per source, all started together; a library is named after the
hash of its source and its flags, so an edited source, or one built with
other flags, is rebuilt and an unchanged one is reused. A failed build
raises: nothing falls back to a plain version. The float kernels (the 9/7
path, the Part-2 MCT, and the float64 distortions, energies and hull slopes
of rate control) are built with -fmad=false (FLOAT_FLAGS): nvcc would
otherwise contract a product and a sum into one fused multiply-add, which
rounds once where the host path rounds twice. Where the host path does
fuse (numpy's float32 matmul of the Part-2 MCT), the source writes
__fmaf_rn itself, which the flag leaves alone.

Every kernel's wrapper adds one to its ``Kernel.launches`` where it calls
the library, and nowhere else (``launch_counts``/``reset_launch_counts``);
a kernel with several forms (K-v, the four horizontal halves of the strip
wavelet) also counts the launches of each form (``form_counts``). A count
is one call of the C entry, not one device launch: a "scratch" form of a
horizontal half is one call that issues several (the 9/7 one six kernels a
plane, the 5/3 one a 2-D copy a plane and one kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

FLOAT_FLAGS = ("-fmad=false",)

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_int64
_F32 = ctypes.c_float


@dataclass
class Kernel:
    """One kernel: its C entry, where its source lives, what it replaces."""

    name: str
    source: str  # file name under csrc/
    replaces: str  # the TPU kernel or XLA program it stands for
    argtypes: tuple
    flags: tuple = ()  # nvcc flags beyond NVCC_FLAGS, the same for every kernel of a source
    launches: int = 0
    forms: dict = field(default_factory=dict)  # launches by form, for kernels with forms

    def call(self, *args, form: str | None = None) -> None:
        """Launch through the C entry; raise on a CUDA error code. ``form``
        names the form launched, for a kernel that has several."""
        fn = getattr(library(self.source), self.name)
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc} at launch")
        self.launches += 1
        if form is not None:
            self.forms[form] = self.forms.get(form, 0) + 1


KERNELS: dict[str, Kernel] = {
    k.name: k
    for k in (
        Kernel("dc_rct_fwd", "dc_rct.cu",
               "grok_tpu/ops/jax_pipeline.py:69 (K2-fwd: DC shift + RCT)",
               (_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P)),
        Kernel("dwt53_fwd_level", "dwt53.cu",
               "grok_tpu/ops/jax_pipeline.py:93 (K2-fwd: dwt.forward / fwd53_axis)",
               (_P, _I64, _P, _I64, _P, _I64, _I32, _I32, _I32, _I32, _P)),
        Kernel("ebcot_symbols", "ebcot_symbols.cu",
               "grok_tpu/t1/ebcot_pallas.py:70 (K1: _build_kernel_wide)",
               (_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I64, _P)),
        Kernel("mq_pack", "mq_pack.cu",
               "grok_tpu/t1/ebcot_pallas.py:399 (host packer of K1)",
               (_P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I64, _I32, _I32,
                _I64, _I32, _P)),
        Kernel("ht_cleanup_enc", "ht_enc.cu",
               "grok_tpu/t1/ht_jax.py:217 (K3: _encode_device, with the host "
               "_stuff_host :503 and _compact :560; block energy :465)",
               (_P,) * 8 + (_I32,) * 6 + (_P, _P), FLOAT_FLAGS),
        Kernel("ht_cleanup_dec", "ht_dec.cu",
               "grok_tpu/t1/ht_jax_dec.py:233 (K4: _decode_device)",
               (_P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _P)),
        Kernel("dwt53_inv_level", "dwt53_inv.cu",
               "grok_tpu/ops/jax_pipeline.py:191 (K2-inv: dwt.inverse / inv53_axis)",
               (_P, _I64, _P, _I64, _P, _I64, _I32, _I32, _I32, _I32, _P)),
        Kernel("rct_inv_dc_clip", "rct_inv.cu",
               "grok_tpu/ops/jax_pipeline.py:198-220 (K2-inv: rct_inverse, DC shift, clip)",
               (_P, _P, _P, _I64) + (_I32,) * 10 + (_P,)),
        Kernel("ebcot_decode", "ebcot_dec.cu",
               "grok_tpu/t1/ebcot_jax.py:760 _build_decoder (K5's decoder)",
               (_P, _I64) + (_P,) * 7 + (_I32,) * 7 + (_P,)),
        Kernel("dc_ict_fwd", "dc_ict.cu",
               "grok_tpu/ops/jax_pipeline.py:69-84 (K2-fwd irreversible: DC shift + "
               "ops/mct.py:48 ict_forward)",
               (_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P), FLOAT_FLAGS),
        Kernel("dwt97_fwd_level", "dwt97.cu",
               "grok_tpu/ops/jax_pipeline.py:93 (K2-fwd irreversible: dwt.forward / "
               "fwd97_axis)",
               (_P, _I64, _P, _I64, _P, _I64, _I32, _I32, _I32, _I32, _P), FLOAT_FLAGS),
        Kernel("quant_deadzone", "quant97.cu",
               "grok_tpu/ops/jax_pipeline.py:96-102 (K2-fwd irreversible: dead-zone "
               "quantization)",
               (_P, _P, _I32, _I32, _P), FLOAT_FLAGS),
        Kernel("dequant_midbin", "quant97.cu",
               "grok_tpu/ops/jax_pipeline.py:177-190 (K2-inv irreversible: mid-bin "
               "dequantization)",
               (_P, _P, _I32, _I32, _P), FLOAT_FLAGS),
        Kernel("dwt97_inv_level", "dwt97.cu",
               "grok_tpu/ops/jax_pipeline.py:191 (K2-inv irreversible: dwt.inverse / "
               "inv97_axis)",
               (_P, _I64, _P, _I64, _P, _I64, _I32, _I32, _I32, _I32, _P), FLOAT_FLAGS),
        Kernel("ict_inv_dc_round_clip", "ict_inv.cu",
               "grok_tpu/ops/jax_pipeline.py:198-217 (K2-inv irreversible: "
               "ops/mct.py:56 ict_inverse, DC shift, round, clip)",
               (_P,) * 6 + (_I64,) + (_F32, _I32, _I32) * 3 + (_I32, _P), FLOAT_FLAGS),
        Kernel("ebcot_pass_dist", "ebcot_dist.cu",
               "grok_tpu/t1/ebcot_jax.py:504 (K5-enc: _build_encoder, its per-pass "
               "distortions _dd_sig_f32/_dd_ref_f32 :472-488)",
               (_P,) * 4 + (_I32,) * 6 + (_P,), FLOAT_FLAGS),
        Kernel("dc_mct_fwd", "mct_custom.cu",
               "grok_tpu/ops/jax_pipeline.py:70-79 (K2-fwd Part-2: DC shift + the "
               "custom MCT, ops/mct.py:83 custom_mct_forward)",
               (_P,) * 3 + (_I64, _I32, _P), FLOAT_FLAGS),
        Kernel("mct_inv_round_clip", "mct_custom.cu",
               "grok_tpu/ops/jax_pipeline.py:192-197, :206-217 (K2-inv Part-2: the "
               "custom inverse MCT, offsets, round, clip)",
               (_P,) * 5 + (_I64, _I32, _P), FLOAT_FLAGS),
        Kernel("roi_up", "roi.cu",
               "grok_tpu/ops/jax_pipeline.py:103-108 (K2-fwd: ROI maxshift upshift)",
               (_P, _I64, _I32, _P)),
        Kernel("roi_down", "roi.cu",
               "grok_tpu/ops/jax_pipeline.py:168-176 (K2-inv: ROI maxshift downshift)",
               (_P, _I64, _I32, _P)),
        Kernel("hull_slopes", "hull.cu",
               "native/pipeline.cpp:630 (hull_slopes, host C++ of "
               "grok_tpu/t2/rate_control.py:17 hull_effective_slopes)",
               (_P,) * 4 + (_I32,) * 2 + (_P,), FLOAT_FLAGS),
        # K6: the sharded-strip wavelet and the tile-parallel block statistics
        Kernel("strip53_step", "strip_dwt.cu",
               "grok_tpu/parallel/mesh.py:65, :93 (K6: _fwd53_v_sharded, _inv53_v_sharded, "
               "their lifting steps with the halos of :36, :45)",
               (_P, _P, _I64, _I32, _I32, _I32, _I32, _P), FLOAT_FLAGS),
        Kernel("strip97_step", "strip_dwt.cu",
               "grok_tpu/parallel/mesh.py:146, :177 (K6: _fwd97_v_sharded, _inv97_v_sharded, "
               "their lifting steps with the halos of :36, :45)",
               (_P, _P, _I64, _I32, _I32, _I32, _F32, _I32, _P), FLOAT_FLAGS),
        Kernel("strip_pack_v", "strip_dwt.cu",
               "grok_tpu/parallel/mesh.py:90, :172-174 (K6: the [s | d] packing and 9/7 "
               "scaling of the sharded forward)",
               (_P, _P, _I64, _I32, _I32, _I32, _I32, _P), FLOAT_FLAGS),
        Kernel("strip_unpack_v", "strip_dwt.cu",
               "grok_tpu/parallel/mesh.py:96-98, :112-114, :181-183, :201-203 (K6: the "
               "unpacking, 9/7 scaling and interleave of the sharded inverse)",
               (_P, _P, _I64, _I32, _I32, _I32, _I32, _P), FLOAT_FLAGS),
        Kernel("dwt53_fwd_h", "strip_h.cu",
               "grok_tpu/parallel/mesh.py:118 (K6: _fwd53_h_local)",
               (_P, _I32, _I64, _I32, _I32, _I32, _P, _P), FLOAT_FLAGS),
        Kernel("dwt53_inv_h", "strip_h.cu",
               "grok_tpu/parallel/mesh.py:130 (K6: _inv53_h_local)",
               (_P, _I32, _I64, _I32, _I32, _I32, _P, _P), FLOAT_FLAGS),
        Kernel("dwt97_fwd_h", "strip_h.cu",
               "grok_tpu/parallel/mesh.py:207 (K6: _fwd97_h_local)",
               (_P, _I32, _I64, _I32, _I32, _I32, _P, _P), FLOAT_FLAGS),
        Kernel("dwt97_inv_h", "strip_h.cu",
               "grok_tpu/parallel/mesh.py:229 (K6: _inv97_h_local)",
               (_P, _I32, _I64, _I32, _I32, _I32, _P, _P), FLOAT_FLAGS),
        Kernel("blk_stats", "blk_stats.cu",
               "grok_tpu/parallel/mesh.py:475-480 (K6: make_sharded_transform's blk_max and "
               "its psum of distortion)",
               (_P, _P, _P, _P, _I32, _I32, _I32, _P)),
    )
}

_LIBS: dict[str, ctypes.CDLL] = {}


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS.values()}


def form_counts() -> dict[str, dict[str, int]]:
    """The launches of each form of the kernels that have forms."""
    return {k.name: dict(k.forms) for k in KERNELS.values() if k.forms}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.forms.clear()


def source_flags(source: str) -> list[str]:
    """The nvcc flags of a source: NVCC_FLAGS and its kernels' own."""
    own = {k.flags for k in KERNELS.values() if k.source == source}
    if len(own) != 1:
        raise ValueError(f"{source}: its kernels disagree on their flags {own}")
    return [*NVCC_FLAGS, *own.pop()]


def _lib_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes()
                            + " ".join(source_flags(source)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_all() -> float:
    """Compile every stale source in parallel; returns the wall seconds.
    Compiler output (register and shared-memory use) goes to
    build/<source>.log."""
    t0 = time.perf_counter()
    sources = sorted({k.source for k in KERNELS.values()})
    todo = [s for s in sources if not _lib_path(s).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for s in todo:
        out = _lib_path(s)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{Path(s).stem}.log", "w")
        p = subprocess.Popen([nvcc, *source_flags(s), "-o", str(tmp), str(CSRC / s)],
                             stdout=log, stderr=subprocess.STDOUT)
        procs.append((s, p, tmp, out, log))
    failed = []
    for s, p, tmp, out, log in procs:
        rc = p.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(s)
    if failed:
        logs = "\n".join((BUILD_DIR / f"{Path(s).stem}.log").read_text()[-4000:]
                         for s in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return time.perf_counter() - t0


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if stale."""
    lib = _LIBS.get(source)
    if lib is None:
        path = _lib_path(source)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for k in KERNELS.values():
            if k.source == source:
                fn = getattr(lib, k.name)
                fn.argtypes = list(k.argtypes)
                fn.restype = ctypes.c_int
        _LIBS[source] = lib
    return lib


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def on_device(device):
    """The context in which a kernel launches on ``device``: that card
    made current (a launch goes to the current card), or nothing for the
    CPU."""
    import contextlib

    import torch

    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
