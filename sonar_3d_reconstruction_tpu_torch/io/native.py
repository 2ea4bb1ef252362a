"""ctypes bindings for the native host-I/O runtime (``native/sonar3d_io.cpp``
at the repo root; a copy of ``sonar_3d_reconstruction_tpu.io.native`` that
builds the library into ``build/native/`` instead of ``native/``).

The C++ library accelerates bag replay's host-side hot loops — batch CDR
decode of Image/Odometry blobs, approximate time pairing, PointCloud2 XYZI
packing — GIL-free.  Everything has a pure-Python path with identical
semantics (io/bag.py, io/timesync.py, io/pointcloud.py); ``available()``
reports whether the library is built and loadable, and ``build()``
compiles it with the host C++ compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SOURCE = os.path.join(_ROOT, "native", "sonar3d_io.cpp")
_LIB_PATH = os.path.join(_ROOT, "build", "native", "libsonar3d_io.so")
# native/Makefile's flags
_CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-Wextra"]

_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the native library if it is missing or older than its
    source; returns its path.  The library is written under a temporary
    name and renamed, so concurrent builds never load a partial file."""
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SOURCE)):
        return _LIB_PATH
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    subprocess.run([cxx, *_CXXFLAGS, "-o", tmp, _SOURCE, "-ldl"],
                   check=True, capture_output=True)
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")

    lib.odometry_decode_batch.restype = ctypes.c_int
    lib.odometry_decode_batch.argtypes = [
        u8p, i64p, ctypes.c_int64, f64p, f64p, f64p,
    ]
    lib.image_decode_batch.restype = ctypes.c_int
    lib.image_decode_batch.argtypes = [
        u8p, i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, f64p, u8p,
    ]
    lib.pair_streams.restype = ctypes.c_int64
    lib.pair_streams.argtypes = [
        f64p, ctypes.c_int64, f64p, ctypes.c_int64, ctypes.c_double,
        ctypes.c_int64, i64p,
    ]
    lib.pack_xyzi.restype = None
    lib.pack_xyzi.argtypes = [f64p, f64p, ctypes.c_int64, f32p]
    lib.s3d_codec_available.restype = ctypes.c_int
    lib.s3d_codec_available.argtypes = [ctypes.c_int]
    lib.s3d_decompress.restype = ctypes.c_int64
    lib.s3d_decompress.argtypes = [
        ctypes.c_int, u8p, ctypes.c_int64, u8p, ctypes.c_int64,
    ]
    lib.s3d_compress_bound.restype = ctypes.c_int64
    lib.s3d_compress_bound.argtypes = [ctypes.c_int, ctypes.c_int64]
    lib.s3d_compress.restype = ctypes.c_int64
    lib.s3d_compress.argtypes = [
        ctypes.c_int, u8p, ctypes.c_int64, u8p, ctypes.c_int64,
    ]
    lib.sonar3d_native_abi_version.restype = ctypes.c_int
    assert lib.sonar3d_native_abi_version() == 3
    _lib = lib
    return lib


def available() -> bool:
    try:
        return _load() is not None
    except Exception:  # load failure OR ABI mismatch -> Python fallback
        return False


def _concat_blobs(blobs: List[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    buf = np.frombuffer(b"".join(blobs), np.uint8)
    return np.ascontiguousarray(buf), offsets


def odometry_decode_batch(
    blobs: List[bytes],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CDR blobs -> (stamps (n,), positions (n,3), quaternions (n,4))."""
    lib = _load()
    assert lib is not None, "native library not built (io.native.build())"
    n = len(blobs)
    buf, offsets = _concat_blobs(blobs)
    stamps = np.empty(n, np.float64)
    positions = np.empty((n, 3), np.float64)
    quats = np.empty((n, 4), np.float64)
    r = lib.odometry_decode_batch(buf, offsets, n, stamps,
                                  positions.reshape(-1), quats.reshape(-1))
    if r != n:
        raise ValueError(f"malformed odometry blob at index {-r - 1}")
    return stamps, positions, quats


def image_decode_batch(
    blobs: List[bytes], height: int, width: int
) -> Tuple[np.ndarray, np.ndarray]:
    """CDR blobs -> (stamps (n,), images (n, height, width) uint8)."""
    lib = _load()
    assert lib is not None, "native library not built (io.native.build())"
    n = len(blobs)
    buf, offsets = _concat_blobs(blobs)
    stamps = np.empty(n, np.float64)
    images = np.empty((n, height, width), np.uint8)
    r = lib.image_decode_batch(
        buf, offsets, n, height, width, stamps, images.reshape(-1)
    )
    if r != n:
        raise ValueError(f"unsupported/malformed image blob at index {-r - 1}")
    return stamps, images


def pair_streams(
    ping_stamps: np.ndarray,
    pose_stamps: np.ndarray,
    slop: float = 0.1,
    queue_size: int = 10,
) -> List[Tuple[int, int]]:
    """Native version of io.timesync.pair_streams (identical policy: the
    faithful ApproximateTimeSynchronizer simulation).

    The C routine requires time-sorted streams; unsorted inputs are sorted
    here and the returned indices mapped back to the caller's order."""
    lib = _load()
    assert lib is not None, "native library not built (io.native.build())"
    ping_stamps = np.ascontiguousarray(ping_stamps, np.float64)
    pose_stamps = np.ascontiguousarray(pose_stamps, np.float64)
    ping_order = np.argsort(ping_stamps, kind="stable")
    pose_order = np.argsort(pose_stamps, kind="stable")
    out = np.empty((max(len(ping_stamps), 1), 2), np.int64)
    n = lib.pair_streams(
        np.ascontiguousarray(ping_stamps[ping_order]), len(ping_stamps),
        np.ascontiguousarray(pose_stamps[pose_order]), len(pose_stamps),
        slop, queue_size, out.reshape(-1),
    )
    return [
        (int(ping_order[i]), int(pose_order[j])) for i, j in out[:n]
    ]


_CODEC_IDS = {"zstd": 0, "lz4": 1}


def codec_available(name: str) -> bool:
    """True when the native library can (de)compress ``name`` chunks
    (resolved from the system libzstd/liblz4 at first use via dlopen)."""
    if name not in _CODEC_IDS:
        return False
    try:
        lib = _load()
    except Exception:
        return False
    return lib is not None and bool(lib.s3d_codec_available(_CODEC_IDS[name]))


def decompress(name: str, data: bytes, uncompressed_size: int) -> bytes:
    """Decompress one mcap chunk (zstd, or lz4 frame format)."""
    lib = _load()
    assert lib is not None, "native library not built (io.native.build())"
    src = np.frombuffer(data, np.uint8)
    if len(src) == 0:
        src = np.zeros(1, np.uint8)
    dst = np.empty(max(uncompressed_size, 1), np.uint8)
    r = lib.s3d_decompress(
        _CODEC_IDS[name], np.ascontiguousarray(src), len(data),
        dst, uncompressed_size,
    )
    if r == -1:
        raise NotImplementedError(f"native {name} codec unavailable")
    if r != uncompressed_size:
        raise ValueError(
            f"corrupt {name} mcap chunk: expected {uncompressed_size} "
            f"uncompressed bytes, decoder produced {r}"
        )
    return dst[:uncompressed_size].tobytes()


def compress(name: str, data: bytes) -> bytes:
    """Compress one mcap chunk body (fixture writer / recorder path)."""
    lib = _load()
    assert lib is not None, "native library not built (io.native.build())"
    cid = _CODEC_IDS[name]
    bound = lib.s3d_compress_bound(cid, len(data))
    if bound < 0:
        raise NotImplementedError(f"native {name} codec unavailable")
    src = np.frombuffer(data, np.uint8)
    if len(src) == 0:
        src = np.zeros(1, np.uint8)
    dst = np.empty(max(int(bound), 1), np.uint8)
    r = lib.s3d_compress(
        cid, np.ascontiguousarray(src), len(data), dst, int(bound)
    )
    if r == -1:
        raise NotImplementedError(f"native {name} codec unavailable")
    if r < 0:
        raise ValueError(f"{name} compression failed")
    return dst[: int(r)].tobytes()


def pack_xyzi(points: np.ndarray, intensities: np.ndarray) -> bytes:
    """Native PointCloud2 XYZI float32 packing (reference node:437-442).

    Available as a GIL-free alternative; the production publish path
    (io/pointcloud.serialize_pointcloud2) uses an equally-vectorized
    numpy pack, so this binding is exercised by tests/benchmarks rather
    than wired in by default."""
    lib = _load()
    assert lib is not None, "native library not built (io.native.build())"
    points = np.ascontiguousarray(points, np.float64).reshape(-1, 3)
    intensities = np.ascontiguousarray(intensities, np.float64)
    if len(intensities) != len(points):
        raise ValueError(
            f"{len(points)} points but {len(intensities)} intensities"
        )
    out = np.empty((len(points), 4), np.float32)
    lib.pack_xyzi(points.reshape(-1), intensities, len(points), out.reshape(-1))
    return out.tobytes()
