"""Native (C++) runtime components, loaded via ctypes.

The reference's runtime is C++ throughout; here the device compute path is
JAX/XLA and the host-side runtime pieces that benefit from native code —
the compact wire serializer (bandwidth-critical, SURVEY.md §5.8) — are
C++ compiled on first use into native/build/.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "build")
_LOCK = threading.Lock()
_LIB = None


def _compile() -> str:
    os.makedirs(_BUILD, exist_ok=True)
    srcs = [os.path.join(_DIR, "serializer.cpp"),
            os.path.join(_DIR, "bus.cpp")]
    so = os.path.join(_BUILD, "libcoxnative.so")
    if (not os.path.exists(so)
            or any(os.path.getmtime(so) < os.path.getmtime(s)
                   for s in srcs)):
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", "-pthread", *srcs, "-o", so + ".tmp"]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(so + ".tmp", so)
    return so


def lib() -> ctypes.CDLL:
    """Load (compiling if needed) the native library."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            L = ctypes.CDLL(_compile())
            L.cox_serialized_bound.restype = ctypes.c_size_t
            L.cox_serialized_bound.argtypes = [ctypes.c_uint32,
                                               ctypes.c_uint32]
            L.cox_serialize.restype = ctypes.c_size_t
            L.cox_serialize.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                ctypes.c_size_t]
            L.cox_peek.restype = ctypes.c_int
            L.cox_peek.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float)]
            L.cox_deserialize.restype = ctypes.c_int
            L.cox_deserialize.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            # message bus (bus.cpp)
            L.cox_bus_serve.restype = ctypes.c_int
            L.cox_bus_serve.argtypes = [ctypes.c_uint16]
            L.cox_bus_stop.restype = None
            L.cox_bus_stop.argtypes = [ctypes.c_int]
            L.cox_bus_connect.restype = ctypes.c_int
            L.cox_bus_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint16]
            L.cox_bus_close.restype = None
            L.cox_bus_close.argtypes = [ctypes.c_int]
            for name in ("cox_bus_subscribe", "cox_bus_advertise"):
                fn = getattr(L, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_int, ctypes.c_char_p]
            L.cox_bus_publish.restype = ctypes.c_int
            L.cox_bus_publish.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                          ctypes.c_void_p, ctypes.c_uint32]
            L.cox_bus_reply.restype = ctypes.c_int
            L.cox_bus_reply.argtypes = [ctypes.c_int, ctypes.c_uint64,
                                        ctypes.c_void_p, ctypes.c_uint32]
            L.cox_bus_poll.restype = ctypes.c_int
            L.cox_bus_poll.argtypes = [ctypes.c_int, ctypes.c_int]
            L.cox_bus_request.restype = ctypes.c_long
            L.cox_bus_request.argtypes = [
                ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p,
                ctypes.c_uint32, ctypes.c_int]
            L.cox_bus_msg_len.restype = ctypes.c_uint32
            L.cox_bus_msg_len.argtypes = [ctypes.c_int]
            L.cox_bus_msg_reqid.restype = ctypes.c_uint64
            L.cox_bus_msg_reqid.argtypes = [ctypes.c_int]
            L.cox_bus_msg_topic.restype = ctypes.c_int
            L.cox_bus_msg_topic.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                            ctypes.c_uint32]
            L.cox_bus_msg_data.restype = ctypes.c_int
            L.cox_bus_msg_data.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_uint32]
            _LIB = L
    return _LIB
