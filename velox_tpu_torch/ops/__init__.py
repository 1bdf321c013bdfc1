"""Device kernels and their wrappers.

Each wrapper counts its kernel's launches in its ``launches`` attribute
through ``count_launch``: the driver threads of a local exchange launch
kernels concurrently, and a bare ``+= 1`` could lose one.
"""

import threading

_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, atomically across threads."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1
