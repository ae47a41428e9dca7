"""Encoder profiles: named configurations of backend + numerics.

The reference has exactly one hard-coded quality/speed point
(encoder.c:95,:517-519).  Profiles keep that point as CONFORMANCE (the
numpy plane) beside FAST (the PyTorch device plane)."""

from .profiles import CONFORMANCE, FAST, Profile, get_profile

__all__ = ["Profile", "CONFORMANCE", "FAST", "get_profile"]
