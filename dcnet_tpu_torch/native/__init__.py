"""The C++ host loader: decode -> letterbox -> normalize of a whole clip or
video in one call, in an in-process thread pool: the port of
`dcnet_tpu/native`.

`host_loader.cc` is compiled with g++ at first use into
`dcnet_tpu_torch/_build/` (listed in `.gitignore`), under a name that hashes
the source and the flags, and bound through ctypes; ctypes releases the GIL
for the call. Its letterbox is a C++ copy of the port's numpy path
(`data/transforms.py`: `resize(..., "area")`, `letterbox`,
`normalize_image`), which it equals bit for bit, not `cv::resize`.

The readers are compiled in by what the machine has, and `formats()` names
them: `.npy` always (the frames `chip_smoke.py` writes and
`generate_synthetic_vid(frame_format="npy")` makes), JPEG through libjpeg
where `jpeglib.h` is found, every other format through OpenCV's `imdecode`
where its `opencv4` headers are found. The build links only those system
libraries; where one of them does not build, the core is built without it.

The datasets' `use_native` (`use_core`): True takes the core and raises
where it is unavailable or cannot read a file of the call, naming what is
missing; None takes it for a call only when it builds and reads every file
of that call, else the numpy / cv2 path, whose pixels are the same (JPEGs
within libjpeg's builds: `tests/test_native.py`'s 2/255); False never takes
it. `DCNET_NO_NATIVE` set to anything non-empty makes the core unavailable
(read at each call). `CALLS` counts the core's calls, so that a run can show
that it went through it.

This module imports no cv2 and builds nothing when it is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "host_loader.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-ffp-contract=off")
_ABI_VERSION = 1
_INCLUDE_DIRS = ("/usr/include", "/usr/local/include")

NPY, JPEG, OPENCV = "npy", "jpeg", "opencv"
_FORMAT_BITS = {NPY: 1, JPEG: 2, OPENCV: 4}
_JPEG_EXTS = (".jpg", ".jpeg", ".jpe", ".jfif")
# what a build needs for each optional reader: its header, the flags and
# the libraries
_OPTIONAL = {
    JPEG: ("jpeglib.h", ("-DDCNET_HAVE_JPEG",), ("-ljpeg",)),
    OPENCV: ("opencv4/opencv2/imgcodecs.hpp", ("-DDCNET_HAVE_OPENCV",),
             ("-lopencv_imgcodecs", "-lopencv_core")),
}

CALLS: Dict[str, int] = {"decode_letterbox_batch": 0, "decode_batch_rgb": 0}
_calls_lock = threading.Lock()    # decode threads call the core concurrently


def reset_calls() -> None:
    with _calls_lock:
        for name in CALLS:
            CALLS[name] = 0


def _count(name: str) -> None:
    with _calls_lock:
        CALLS[name] += 1


class _Core:
    """The loaded library (or why there is none), the formats it reads and
    why each other format is missing."""

    def __init__(self, lib: Optional[ctypes.CDLL], formats: Tuple[str, ...],
                 missing: Dict[str, str], error: Optional[str]):
        self.lib, self.formats, self.missing, self.error = lib, formats, missing, error


_lock = threading.Lock()
_core: Optional[_Core] = None


def compiler() -> Optional[str]:
    """The C++ compiler: $CXX, then g++ on PATH."""
    return os.environ.get("CXX") or shutil.which("g++")


def _find_header(rel: str) -> Optional[str]:
    """The include directory that holds `rel`, or None."""
    for inc in _INCLUDE_DIRS:
        if os.path.exists(os.path.join(inc, rel)):
            return inc
    return None


def _target(flags: Sequence[str]) -> str:
    digest = hashlib.sha256(" ".join(flags).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"host_loader-{digest.hexdigest()[:12]}.so")


def _compile(cxx: str, readers: Sequence[str]) -> Tuple[Optional[str], str]:
    """Build the core with the optional `readers`: (library path or None,
    the compiler's output where it failed). Each build goes to a per-pid temporary file and
    is renamed into place, so processes and threads that race for the first
    build never load a half-written library."""
    flags, libs = list(CXX_FLAGS), []
    for name in readers:
        header, defs, names = _OPTIONAL[name]
        flags += defs
        if name == OPENCV:
            flags.append("-I" + os.path.join(_find_header(header), "opencv4"))
        libs += names
    path = _target(flags + libs)
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run([cxx, *flags, _SRC, "-o", tmp, *libs],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return None, f"{cxx} failed to run: {e}"
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return None, f"{cxx} exit {proc.returncode}:\n{proc.stderr[-3000:]}"
    os.replace(tmp, path)
    return path, ""


def _bind(lib: ctypes.CDLL) -> None:
    c_char_pp = ctypes.POINTER(ctypes.c_char_p)
    f32p, f64p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double)
    u8p, i32p = ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int)
    lib.dcnet_host_abi_version.restype = ctypes.c_int
    lib.dcnet_host_abi_version.argtypes = []
    lib.dcnet_host_formats.restype = ctypes.c_int
    lib.dcnet_host_formats.argtypes = []
    lib.dcnet_decode_letterbox_batch.restype = ctypes.c_int
    lib.dcnet_decode_letterbox_batch.argtypes = [
        c_char_pp, ctypes.c_int, ctypes.c_int, f32p, f32p, f64p, f32p, f64p, f64p,
        f64p, u8p, ctypes.c_int]
    lib.dcnet_decode_batch_open.restype = ctypes.c_void_p
    lib.dcnet_decode_batch_open.argtypes = [c_char_pp, ctypes.c_int, i32p, ctypes.c_int]
    lib.dcnet_decode_batch_copy.restype = ctypes.c_int
    lib.dcnet_decode_batch_copy.argtypes = [ctypes.c_void_p, ctypes.c_int, u8p]
    lib.dcnet_decode_batch_close.restype = None
    lib.dcnet_decode_batch_close.argtypes = [ctypes.c_void_p]


def _load() -> _Core:
    """Build (once a process) the core with every optional reader whose
    header is found, dropping a reader whose build fails, and load it."""
    cxx = compiler()
    if cxx is None:
        return _Core(None, (), {}, "no C++ compiler: g++ is not on PATH and $CXX "
                     "is not set")
    missing = {name: f"{header} was not found under {' or '.join(_INCLUDE_DIRS)}"
               for name, (header, _, _) in _OPTIONAL.items() if not _find_header(header)}
    readers = [name for name in _OPTIONAL if name not in missing]
    while True:
        path, log = _compile(cxx, readers)
        if path is not None or not readers:
            break
        dropped = readers.pop()  # the last reader's library is the likeliest to fail
        missing[dropped] = f"the build with {dropped} failed:\n{log}"
    if path is None:
        return _Core(None, (), missing, f"the host loader did not build:\n{log}")
    lib = ctypes.CDLL(path)
    _bind(lib)
    if lib.dcnet_host_abi_version() != _ABI_VERSION:
        return _Core(None, (), missing, f"{path} has ABI {lib.dcnet_host_abi_version()}, "
                     f"not {_ABI_VERSION}")
    bits = lib.dcnet_host_formats()
    formats = tuple(name for name, bit in _FORMAT_BITS.items() if bits & bit)
    return _Core(lib, formats, missing, None)


def _get() -> _Core:
    global _core
    if _core is None:
        with _lock:
            if _core is None:
                _core = _load()
    return _core


def _disabled() -> bool:
    return bool(os.environ.get("DCNET_NO_NATIVE"))


def available() -> bool:
    """Whether the core builds and loads here (and DCNET_NO_NATIVE is unset)."""
    return not _disabled() and _get().lib is not None


def unavailable_reason() -> Optional[str]:
    if _disabled():
        return "disabled by DCNET_NO_NATIVE"
    return _get().error


def formats() -> Tuple[str, ...]:
    """The formats this build reads: 'npy', and 'jpeg' (libjpeg) and
    'opencv' (every other format, through imdecode) where they were
    compiled in; () where the core is unavailable."""
    return _get().formats if available() else ()


def format_of(path: str) -> str:
    """The reader a file needs, by its extension."""
    ext = os.path.splitext(path)[1].lower()
    return NPY if ext == ".npy" else JPEG if ext in _JPEG_EXTS else OPENCV


def missing(path: str) -> Optional[str]:
    """Why the core cannot read `path` (None where it can)."""
    if not available():
        return f"the host loader is unavailable: {unavailable_reason()}"
    fmt = format_of(path)
    if fmt in formats() or (fmt == JPEG and OPENCV in formats()):
        return None
    return f"this build reads no {fmt} files: {_get().missing.get(fmt, 'not compiled in')}"


def reads(paths: Sequence[str]) -> bool:
    """Whether the core is available and reads every file of `paths`."""
    return available() and all(missing(p) is None for p in paths)


def use_core(use_native: Optional[bool], paths: Sequence[str]) -> bool:
    """The datasets' rule for one call: True requires the core (raising,
    with what is missing, where it cannot read a file of `paths`), None
    takes it where it reads them all, False never."""
    if use_native is False:
        return False
    if use_native:
        for p in paths:
            why = missing(p)
            if why is not None:
                raise RuntimeError(f"the C++ host loader was requested (use_native=True) "
                                   f"and cannot read {p}: {why}")
        return True
    return reads(paths)


def _lib() -> ctypes.CDLL:
    if not available():
        raise RuntimeError(f"the C++ host loader is unavailable: {unavailable_reason()}")
    return _get().lib


def _paths_array(paths: Sequence[str]):
    enc = [os.fsencode(p) for p in paths]
    return (ctypes.c_char_p * len(enc))(*enc), enc  # enc keeps the bytes alive


def _threads(n: int, num_threads: int) -> int:
    return num_threads if num_threads > 0 else max(1, min(n, os.cpu_count() or 1))


def decode_letterbox_batch(
    paths: Sequence[str], size: int, mean: np.ndarray, std: np.ndarray,
    pad: Tuple[float, float, float] = (123.7, 116.3, 103.5), num_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Decode, letterbox and normalize `paths`: (images float32 [n, size,
    size, 3], ratios, dws, dhs float64 [n], ok bool [n]), equal to
    `normalize_image(letterbox(read_image(p), size))` bit for bit. A failed
    decode zeroes its slot and sets ok False. `num_threads` <= 0 takes
    min(n, os.cpu_count())."""
    lib = _lib()
    n = len(paths)
    out = np.empty((n, size, size, 3), np.float32)
    ratios, dws, dhs = (np.empty(n, np.float64) for _ in range(3))
    ok = np.empty(n, np.uint8)
    mean32 = np.ascontiguousarray(mean, np.float32)
    std32 = np.ascontiguousarray(std, np.float32)
    pad64 = np.ascontiguousarray(pad, np.float64)
    if mean32.shape != (3,) or std32.shape != (3,) or pad64.shape != (3,):
        raise ValueError("mean, std and pad take 3 values each (RGB)")
    arr, _keep = _paths_array(paths)
    f32p, f64p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double)
    lib.dcnet_decode_letterbox_batch(
        arr, n, int(size), mean32.ctypes.data_as(f32p), std32.ctypes.data_as(f32p),
        pad64.ctypes.data_as(f64p), out.ctypes.data_as(f32p), ratios.ctypes.data_as(f64p),
        dws.ctypes.data_as(f64p), dhs.ctypes.data_as(f64p),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), _threads(n, num_threads))
    _count("decode_letterbox_batch")
    return out, ratios, dws, dhs, ok.astype(bool)


def decode_batch_rgb(paths: Sequence[str], num_threads: int = 0
                     ) -> List[Optional[np.ndarray]]:
    """Decode `paths` in parallel to uint8 RGB (H, W, 3) arrays, equal to
    `read_image`'s; None for a failed decode."""
    lib = _lib()
    n = len(paths)
    dims = np.zeros(2 * n, np.int32)
    arr, _keep = _paths_array(paths)
    handle = lib.dcnet_decode_batch_open(
        arr, n, dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), _threads(n, num_threads))
    _count("decode_batch_rgb")
    try:
        out: List[Optional[np.ndarray]] = []
        for i in range(n):
            h, w = int(dims[2 * i]), int(dims[2 * i + 1])
            buf = np.empty((h, w, 3), np.uint8) if h else None
            if buf is not None and lib.dcnet_decode_batch_copy(
                    handle, i, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))) != 0:
                buf = None
            out.append(buf)
        return out
    finally:
        lib.dcnet_decode_batch_close(handle)


def decode_failed(path: str) -> Exception:
    """The error of a frame the core could not decode: FileNotFoundError
    where the file is missing, else ValueError."""
    if not os.path.exists(path):
        return FileNotFoundError(path)
    return ValueError(f"{path}: the host loader could not decode it")
