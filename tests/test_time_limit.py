"""The suite's settings: a test that overruns its time limit
(``tests/time_limit.py``) fails with the limit's message and the run goes on
to the next test, a ``slow`` test runs without the limit, and each test
process computes on the threads that ``tests/__init__.py`` sets."""
import os
import subprocess
import sys
import textwrap
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def test_time_limit_fails_a_test_that_overruns(tmp_path):
    (tmp_path / "conftest.py").write_text(textwrap.dedent("""\
        from time_limit import TimeLimit

        def pytest_configure(config):
            config.addinivalue_line("markers", "slow: not timed")
            config.pluginmanager.register(TimeLimit(2), "time_limit")
        """))
    (tmp_path / "test_sleeps.py").write_text(textwrap.dedent("""\
        import time

        import pytest

        def test_sleeps():
            time.sleep(30)

        def test_after():
            pass

        @pytest.mark.slow
        def test_slow_is_not_timed():
            time.sleep(3)
        """))
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (HERE, env.get("PYTHONPATH")) if p)
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                          str(tmp_path)], capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=60)
    took = time.monotonic() - t0
    out = res.stdout + res.stderr
    assert res.returncode == 1, out
    assert "1 failed, 2 passed" in res.stdout, out
    assert "TimeLimitExceeded: the test took longer than its time limit of 2 s" in out, out
    assert took < 15, (took, out)


def test_one_compute_thread_per_test_process():
    import torch
    assert torch.get_num_threads() == int(os.environ["OMP_NUM_THREADS"])
    assert "--xla_cpu_multi_thread_eigen=false" in os.environ["XLA_FLAGS"].split()
