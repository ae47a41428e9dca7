"""Host-side JPEG XL codestream serialization plane (the port's copy of
hydrium_tpu.jxl).

Pure-Python reference implementations with C++ fast paths for the hot
serial loops (csrc/host/serializer.cc, built by jxl/native.py).
Everything here operates on host arrays; the device plane is `ops`.
"""
