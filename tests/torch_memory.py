"""A module fixture for the port's test files: give back the memory that
the reference package's traces hold in this process.

In a parallel run the port's test files (`test_torch_*.py`) come after
the reference's, in worker processes that still hold the compiled
programs of the tests before them and the freed heap glibc has not
returned (several GiB a worker; a few such workers can fill the host's
memory, and then the run stalls).  Each port test module drops JAX's in-memory
caches (the persistent compilation cache on disk stays) and returns the
free heap to the system when it starts and when it ends.

Import the fixture into a test module to apply it there:

    from torch_memory import release_memory  # noqa: F401
"""

import ctypes
import gc

import jax
import pytest

try:
    _malloc_trim = ctypes.CDLL("libc.so.6").malloc_trim
except (OSError, AttributeError):           # not glibc: nothing to return
    _malloc_trim = None


def release() -> None:
    jax.clear_caches()
    gc.collect()
    if _malloc_trim is not None:
        _malloc_trim(0)


@pytest.fixture(autouse=True, scope="module")
def release_memory():
    release()
    yield
    release()
