"""One time limit for a test's setup, call and teardown together.

``TimeLimit(seconds)`` is a pytest plugin.  It covers each test that is not
marked ``slow``.  Within each phase a
``SIGALRM`` timer raises ``TimeLimitExceeded`` in the main thread once the
test's time is spent, and the phase fails.  Teardown always starts, so that
fixtures release what they hold, but runs under the timer only while time is
left.  ``faulthandler`` is the backstop for a hang inside C code that the
signal cannot interrupt: ``BACKSTOP_S`` after the limit it prints every
thread's stack and ends the process (under xdist the controller starts a new
worker).
"""
import faulthandler
import os
import signal
import time

import pytest

BACKSTOP_S = 60


class TimeLimitExceeded(Exception):
    pass


class TimeLimit:
    def __init__(self, seconds: float):
        self.seconds = seconds
        self.deadline = None      # None: the running test is not covered
        self.stderr = None

    def pytest_configure(self, config):
        # the stacks go to the stderr that pytest's capture replaces
        capture = config.pluginmanager.getplugin("capturemanager")
        with capture.global_and_fixture_disabled():
            self.stderr = os.dup(2)

    def pytest_unconfigure(self):
        os.close(self.stderr)

    def _expired(self, *_):
        raise TimeLimitExceeded(
            f"the test took longer than its time limit of {self.seconds} s "
            "(setup, call and teardown together)")

    def _timed(self, may_raise: bool):
        if self.deadline is None:
            return (yield)
        left = self.deadline - time.monotonic()
        if left <= 0 and may_raise:
            self._expired()
        previous = signal.signal(signal.SIGALRM, self._expired)
        signal.setitimer(signal.ITIMER_REAL, max(left, 0))   # 0: no timer
        try:
            return (yield)
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_protocol(self, item):
        if item.get_closest_marker("slow"):
            self.deadline = None
            return (yield)
        self.deadline = time.monotonic() + self.seconds
        faulthandler.dump_traceback_later(self.seconds + BACKSTOP_S, exit=True,
                                          file=self.stderr)
        try:
            return (yield)
        finally:
            faulthandler.cancel_dump_traceback_later()

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_setup(self):
        return (yield from self._timed(True))

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_call(self):
        return (yield from self._timed(True))

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_teardown(self):
        return (yield from self._timed(False))
