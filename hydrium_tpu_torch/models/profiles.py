"""Named encoder profiles (the port's copy of
hydrium_tpu/models/profiles.py)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Profile:
    """An encoder configuration point, passed to Encoder(profile=...).

    backend: math plane ("numpy" = bit-exact with the reference's
    fixed-point/LUT arithmetic, host only; "torch" = the PyTorch device
    plane with direct float math).
    """

    name: str
    backend: str


#: Byte-identical to the reference encoder for identical inputs.
CONFORMANCE = Profile(name="conformance", backend="numpy")

#: The device plane (CUDA kernels on the card).
FAST = Profile(name="fast", backend="torch")

_PROFILES = {p.name: p for p in (CONFORMANCE, FAST)}


def get_profile(name: str) -> Profile:
    try:
        return _PROFILES[name]
    except KeyError:
        raise ValueError(
            f"unknown profile {name!r}; available: {sorted(_PROFILES)}")
