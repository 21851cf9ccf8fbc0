"""Test config: force CPU JAX with a virtual 8-device mesh so sharding tests
run anywhere; locate reference Grok binaries for interop tests if present."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")  # this env's plugin ignores JAX_PLATFORMS
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

try:  # make doubly sure the virtual CPU mesh is used even if env is ignored
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")
except Exception:
    pass

import shutil
import subprocess

import numpy as np
import pytest

GRK_BIN = None
for cand in ("/tmp/grok-build/bin", "/usr/local/bin", "/usr/bin"):
    if os.path.exists(os.path.join(cand, "grk_compress")):
        GRK_BIN = cand
        break


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (grok_tpu_torch kernels); skips without one")


def have_grok() -> bool:
    return GRK_BIN is not None


def grk_compress(args: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(
        [os.path.join(GRK_BIN, "grk_compress"), *args], capture_output=True, text=True
    )


def grk_decompress(args: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(
        [os.path.join(GRK_BIN, "grk_decompress"), *args], capture_output=True, text=True
    )


def golden_md5(planes) -> str:
    """The corpus golden digest: md5 over each component plane as
    contiguous int32 bytes + str(shape), in component order. One recipe,
    shared by tests/test_conformance.py and tools/gen_corpus.py."""
    import hashlib

    h = hashlib.md5()
    for a in planes:
        a = np.ascontiguousarray(np.asarray(a).astype(np.int32))
        h.update(a.tobytes())
        h.update(str(a.shape).encode())
    return h.hexdigest()


def read_pgx(fn: str) -> np.ndarray:
    with open(fn, "rb") as f:
        hdr = f.readline().decode().split()
        w, h = int(hdr[-2]), int(hdr[-1])
        depth = int(hdr[-3].lstrip("+-"))
        signed = "-" in hdr[-3] or hdr[2].startswith("-")
        kind = "i" if signed else "u"
        dt = f">{kind}2" if depth > 8 else f"{kind}1"
        return np.frombuffer(f.read(), dtype=dt).reshape(h, w).astype(np.int32)


def save_pnm(fn: str, arr: np.ndarray, prec: int = 8) -> None:
    from PIL import Image as PImage

    if prec == 8:
        PImage.fromarray(arr.astype(np.uint8)).save(fn)
    else:
        assert arr.ndim == 2
        with open(fn, "wb") as f:
            f.write(f"P5\n{arr.shape[1]} {arr.shape[0]}\n{(1 << prec) - 1}\n".encode())
            f.write(arr.astype(">u2").tobytes())


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def natural_image(h, w, nc=1, prec=8, seed=3):
    """Pseudo-natural content: smooth base + texture + block edges."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.5 + 0.3 * np.sin(xx / 23) * np.cos(yy / 31)
    tex = r.standard_normal((h, w)) * 0.02
    edges = ((xx // 40 + yy // 40) % 2) * 0.2
    v = np.clip(base + tex + edges, 0, 1)
    arr = (v * ((1 << prec) - 1)).astype(np.int32)
    if nc > 1:
        arr = np.stack(
            [arr]
            + [
                np.clip(arr + r.integers(-20, 20, (h, w)), 0, (1 << prec) - 1)
                for _ in range(nc - 1)
            ],
            -1,
        ).astype(np.int32)
    return arr
