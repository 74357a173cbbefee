"""The test suite.  Importing it, as pytest does before ``tests/conftest.py``
imports JAX, gives the test process one compute thread: the workers of
``pytest -n`` share the machine's cores, and pools that each take all of
them spend the run handing work between threads.  ``OMP_NUM_THREADS`` sets
torch's pool and OpenMP's, ``MKL_NUM_THREADS`` MKL's, and
``--xla_cpu_multi_thread_eigen=false`` XLA's.  Processes that the tests
start inherit the environment."""
import os

os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("MKL_NUM_THREADS", "1")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_cpu_multi_thread_eigen" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_cpu_multi_thread_eigen=false").strip()
