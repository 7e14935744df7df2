"""Python binding for the C++ shared-memory MPMC queue (ctypes).

The port's own copy of `sample_factory_tpu/native/shm_queue.py`: the equivalent
of the reference's faster-fifo queues (the signal/control channel of the
actor-learner system). `csrc/sf_shm_queue.cpp` is compiled on first use with
g++ into `sample_factory_tpu_torch/_build/sf_shm_queue_<hash>.so`, named by a
hash of the source and the flags as the CUDA kernels' library is; nothing is
written beside the source. Without a native toolchain `ShmQueue.available()`
is False and callers fall back to multiprocessing pipes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pickle
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, List, Optional

from sample_factory_tpu_torch.utils.utils import log

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "sf_shm_queue.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC"]
LINK_FLAGS = ["-lpthread", "-lrt"]

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
_BUILD_FAILED = False


def library_path() -> Path:
    """The built library for the current source and flags (keyed by their hash)."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS + LINK_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"sf_shm_queue_{digest}.so"


def build() -> Path:
    """Compile the queue into `_build/` unless this version is already there. Raises when
    there is no compiler or it fails. Processes that build at once each write a file of
    their own and rename it into place."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError("g++ not found: the shared-memory queue cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LINK_FLAGS]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr[-2000:]}")
    os.replace(tmp, path)
    return path


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _BUILD_FAILED
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        if _BUILD_FAILED:
            return None
        try:
            path = build()
        except Exception as e:  # noqa: BLE001 - no toolchain: the callers take pipes
            log.warning("Could not build the shared-memory queue (%s); falling back to mp pipes", e)
            _BUILD_FAILED = True
            return None
        lib = ctypes.CDLL(str(path))
        lib.sfq_create.restype = ctypes.c_void_p
        lib.sfq_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.sfq_attach.restype = ctypes.c_void_p
        lib.sfq_attach.argtypes = [ctypes.c_char_p]
        lib.sfq_put_many.restype = ctypes.c_int
        lib.sfq_put_many.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_uint32,
            ctypes.c_double,
        ]
        lib.sfq_get_many.restype = ctypes.c_int
        lib.sfq_get_many.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_double,
        ]
        lib.sfq_size.restype = ctypes.c_uint64
        lib.sfq_size.argtypes = [ctypes.c_void_p]
        lib.sfq_mark_closed.argtypes = [ctypes.c_void_p]
        lib.sfq_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _LIB = lib
        return _LIB


class QueueEmpty(Exception):
    pass


class QueueFull(Exception):
    pass


class ShmQueue:
    """Pickle-message MPMC queue over the native ring buffer.

    API mirrors faster-fifo: put(msg), get(), get_many(max_messages), qsize().
    """

    RECV_BUF = 1 << 20

    def __init__(self, name: Optional[str] = None, capacity_bytes: int = 8 << 20, create: bool = True):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native shm queue unavailable")
        self._lib = lib
        self.name = name or f"/sfq_{os.getpid()}_{id(self) & 0xFFFFFF:x}"
        if not self.name.startswith("/"):
            self.name = "/" + self.name
        if create:
            self._h = lib.sfq_create(self.name.encode(), capacity_bytes)
        else:
            self._h = lib.sfq_attach(self.name.encode())
        if not self._h:
            raise RuntimeError(f"could not {'create' if create else 'attach'} shm queue {self.name}")
        self._owner = create
        self._recv_buf = ctypes.create_string_buffer(self.RECV_BUF)
        self._recv_sizes = (ctypes.c_uint32 * 1024)()

    @staticmethod
    def available() -> bool:
        return _get_lib() is not None

    # -- pickling across process boundaries: re-attach by name
    def __getstate__(self):
        return {"name": self.name}

    def __setstate__(self, state):
        self.__init__(name=state["name"], create=False)

    def put(self, msg: Any, timeout: float = 5.0) -> None:
        self.put_many([msg], timeout=timeout)

    def put_many(self, msgs: List[Any], timeout: float = 5.0) -> None:
        payloads = [pickle.dumps(m, protocol=pickle.HIGHEST_PROTOCOL) for m in msgs]
        blob = b"".join(payloads)
        sizes = (ctypes.c_uint32 * len(payloads))(*[len(p) for p in payloads])
        rc = self._lib.sfq_put_many(self._h, blob, sizes, len(payloads), timeout)
        if rc == 1:
            raise QueueFull()
        if rc != 0:
            raise RuntimeError(f"sfq_put_many rc={rc}")

    def get(self, timeout: float = 5.0) -> Any:
        return self.get_many(max_messages=1, timeout=timeout)[0]

    def get_many(self, max_messages: int = 1024, timeout: float = 5.0) -> List[Any]:
        count = ctypes.c_uint32(0)
        max_messages = min(max_messages, 1024)
        rc = self._lib.sfq_get_many(
            self._h, self._recv_buf, self.RECV_BUF, max_messages, self._recv_sizes, ctypes.byref(count), timeout
        )
        if rc == 1:
            raise QueueEmpty()
        if rc != 0:
            raise RuntimeError(f"sfq_get_many rc={rc}")
        out, offset = [], 0
        sizes = self._recv_sizes[: count.value]
        raw = ctypes.string_at(self._recv_buf, sum(sizes))  # the received bytes only, not the whole buffer
        for sz in sizes:
            try:
                out.append(pickle.loads(raw[offset : offset + sz]))
            except Exception as e:  # noqa: BLE001
                # a peer killed mid-put (robust mutex recovered with a
                # partially written message) surfaces as corrupt pickle bytes;
                # report it as a peer failure, not a decode bug
                raise RuntimeError(f"shm queue {self.name}: corrupt message (peer died mid-write?): {e}") from e
            offset += sz
        return out

    def qsize(self) -> int:
        return int(self._lib.sfq_size(self._h))

    def mark_closed(self) -> None:
        self._lib.sfq_mark_closed(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.sfq_close(self._h, 1 if self._owner else 0)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
