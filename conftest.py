"""Settings for a run that collects the suite under ``tests/``; a run of
``benchmark/`` alone is left as it is.

Every ``quality`` floor under ``tests/`` is ``slow`` too, so
``-m 'not slow'`` leaves it out and ``-m quality`` still runs it.  Each test
that is not ``slow`` runs under one time limit, ``tests/time_limit.py``.
Each test process has a JAX compilation cache of its own for the session:
JAX then compiles a program once, however many functions trace to it (the
Pallas kernels in interpret mode compile the same programs for every
configuration that a test compares).  Importing the ``tests`` package sets
the threads (``tests/__init__.py``)."""
import os
import shutil
import tempfile

import pytest

TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
# seconds for each test's setup, call and teardown together
TIME_LIMIT_S = 300
jax_cache = None


def pytest_collection_modifyitems(config, items):
    global jax_cache
    ours = [item for item in items if str(item.path).startswith(TESTS + os.sep)]
    for item in ours:
        if item.get_closest_marker("quality"):
            item.add_marker(pytest.mark.slow)
    if ours:
        import jax

        from tests.time_limit import TimeLimit
        config.pluginmanager.register(TimeLimit(TIME_LIMIT_S), "time_limit")
        jax_cache = tempfile.mkdtemp(prefix="jax-cache-")
        jax.config.update("jax_compilation_cache_dir", jax_cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)


def pytest_sessionfinish():
    # here, before a worker of ``pytest -n`` reports that it finished
    if jax_cache:
        shutil.rmtree(jax_cache, ignore_errors=True)
