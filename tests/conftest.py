"""Test configuration: force a fast 8-device virtual CPU mesh.

Tests run on the CPU; multi-device sharding is validated on a host-platform
device mesh. Code that only the GPU can run carries the ``gpu`` marker and
is exercised on the card by ``chip_smoke.py``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
