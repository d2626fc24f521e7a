"""Suite-wide pytest settings: the ``gpu`` marker, the order tests start
in, how pytest-xdist hands them out, and the release of JAX's compiled
programs in a worker that holds too many.

Why the order and the hand-out: the suite's cost is dominated by a few
tests that take minutes each on a CPU (the subprocess tests of
``test_distributed.py``, which emulate a device mesh, interpret-mode
ResNet serving, the hypothesis fuzzer), the rest taking seconds. With
``--dist load`` xdist gives every worker a first run of N // 24
consecutive tests, so a whole module of long tests could queue on one
worker, and where the batch boundaries fell moved with the test count N.
Here the known long tests come first, longest first, and xdist hands a
worker one test at a time (a worker runs a test once it holds the next
one, so it holds two): behind a long test a short one, so no long test
waits behind another; else a long test while one waits; else the next
test of the worker's module, whose compiled programs it holds; else the
first waiting. A module of ``GROUPED_MODULES`` goes to one worker whole,
so its module-scoped fixtures are built once. At most
``SUBPROCESS_LANES`` workers hold subprocess tests at a time (each runs
an 8-device XLA process beside the workers; their own timeouts are 420 s
and 560 s), and while an ``EXCLUSIVE`` one runs no other subprocess
test and no other long test starts. The order is a fixed function of
the collected items, the same on every worker, as xdist requires.

Why the priorities: the subprocess tests have wall-clock timeouts, and
the hypothesis fuzzer is the longest test and so the run's floor; beside
five busy workers both ran slower than alone (the fuzzer did not end in
the 1,470 s the whole run may take). Where a worker may raise its
priority again (CAP_SYS_NICE), it runs at ``os.nice(WORKER_NICE)`` and
returns to the normal priority for a test in ``PRIORITY_MODULES`` or
``PRIORITY_TESTS`` (its subprocess inherits it); the other tests take
the cores those leave.

Why the release: every XLA CPU executable a process keeps holds memory
maps of its own, and a process past the kernel's limit on maps (65,530
by default) aborts. After a test module, a worker past ``MAPS_RELEASE``
maps drops JAX's compiled programs (``jax.clear_caches()`` and a garbage
collection); below it they stay cached for the tests that follow. Only
where JAX is already imported: a worker running port tests alone never
imports it.
"""
import gc
import os
import sys

import pytest

#: Tests that take minutes each, longest first (per-test wall times of
#: the suite under ``-n 6`` on an 8-core machine). They start first.
LONG_TESTS = (
    "tests/test_differential.py::test_differential_parity_hypothesis",
    "tests/test_distributed.py::test_sharded_fused_serving_parity",
    "tests/test_conv_engine.py::test_resnet_int8_serving",
    "tests/test_distributed.py::"
    "test_sharded_export_restore_serve_under_mesh",
    "tests/test_distributed.py::test_one_xq_across_modes_and_f63_sharded",
    "tests/test_serving.py::test_padded_parity_bitwise_conv_engine[legendre]",
    "tests/test_distributed.py::test_tp_f63_and_small_slab_regression",
    "tests/test_distributed.py::test_tp_reshard_on_restore",
    "tests/test_distributed.py::"
    "test_planned_checkpoint_restores_into_mesh_engine",
    "tests/test_distributed.py::test_tp_2d_sharded_parity_sweep",
)

#: Modules whose tests run a multi-device XLA subprocess each, and how
#: many workers may hold such a test at once.
SUBPROCESS_MODULES = ("tests/test_distributed.py",)
SUBPROCESS_LANES = 2
#: Subprocess tests during which no other subprocess test and no other
#: long test starts (closest to their timeout).
EXCLUSIVE = ("tests/test_distributed.py::test_sharded_fused_serving_parity",)

#: Modules whose tests share module-scoped fixtures (a JAX compile of
#: their references): handed to one worker together.
GROUPED_MODULES = (
    "tests/test_torch_conv1d.py",
    "tests/test_torch_lm.py",
    "tests/test_torch_lm_layers.py",
    "tests/test_torch_q8.py",
    "tests/test_torch_resnet.py",
    "tests/test_torch_train.py",
)

#: Tests that run at the normal priority while the other tests of a
#: worker run at ``WORKER_NICE`` (see the module docstring).
PRIORITY_MODULES = SUBPROCESS_MODULES
PRIORITY_TESTS = (
    "tests/test_differential.py::test_differential_parity_hypothesis",)
WORKER_NICE = 10

#: Memory maps past which a worker drops JAX's compiled programs after a
#: test module (about half the kernel's default limit).
MAPS_RELEASE = 32000


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (sm_90a) and nvcc; skips without")
    if hasattr(config, "workerinput") and _may_raise_priority():
        os.nice(WORKER_NICE)                    # an xdist worker


def _may_raise_priority() -> bool:
    """Whether this process may lower its nice value again
    (CAP_SYS_NICE): without it a worker keeps the normal priority, as a
    niced worker could not return to it for a priority test."""
    try:
        with open("/proc/self/status") as f:
            caps = next(line for line in f if line.startswith("CapEff:"))
        return bool(int(caps.split()[1], 16) >> 23 & 1)
    except (OSError, StopIteration, ValueError, IndexError):
        return False


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    """A priority test runs at the normal priority, and its subprocess
    inherits it (see the module docstring)."""
    raise_it = os.getpriority(os.PRIO_PROCESS, 0) > 0 and (
        item.nodeid in PRIORITY_TESTS
        or _module(item.nodeid) in PRIORITY_MODULES)
    if raise_it:
        os.setpriority(os.PRIO_PROCESS, 0, 0)
    try:
        yield
    finally:
        if raise_it:
            os.setpriority(os.PRIO_PROCESS, 0, WORKER_NICE)


def pytest_collection_modifyitems(session, config, items):
    """The long tests first, in ``LONG_TESTS`` order; the others keep
    their collection order (a stable sort)."""
    rank = {nodeid: i for i, nodeid in enumerate(LONG_TESTS)}
    items.sort(key=lambda item: rank.get(item.nodeid, len(rank)))


def _module(nodeid: str) -> str:
    return nodeid.split("::")[0]


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    """Under ``--dist load``, the hand-out of the module docstring; other
    ``--dist`` modes, and xdist releases other than 3.x (whose
    ``LoadScheduling`` keeps ``pending``, ``node2pending`` and
    ``collection`` as used here), keep xdist's own scheduler."""
    import xdist
    if config.getoption("dist") != "load" or \
            not xdist.__version__.startswith("3."):
        return None
    from xdist.scheduler import LoadScheduling

    class OneAtATime(LoadScheduling):
        def __init__(self, config, log=None):
            super().__init__(config, log)
            self.maxschedchunk = 1

        def _pick(self, node) -> list:
            """The tests to send ``node`` next (see the module
            docstring)."""
            ids = self.collection
            held = self.node2pending[node]
            lanes = [[ids[i] for i in p
                      if _module(ids[i]) in SUBPROCESS_MODULES]
                     for n, p in self.node2pending.items() if n is not node]
            lanes = [ls for ls in lanes if ls]
            quiet = any(x in EXCLUSIVE for ls in lanes for x in ls)

            def allowed_now(i):
                nodeid = ids[i]
                if quiet and nodeid in LONG_TESTS:
                    return False
                if _module(nodeid) not in SUBPROCESS_MODULES:
                    return True
                if quiet:
                    return False
                if nodeid in EXCLUSIVE:
                    return not lanes
                return len(lanes) < SUBPROCESS_LANES
            allowed = ([i for i in self.pending if allowed_now(i)]
                       or self.pending[:1])
            if held and ids[held[-1]] in LONG_TESTS:
                pick = next((i for i in allowed if ids[i] not in LONG_TESTS
                             and _module(ids[i]) not in GROUPED_MODULES),
                            allowed[0])
            else:
                here = _module(ids[held[-1]]) if held else None
                pick = next((i for i in allowed if ids[i] in LONG_TESTS),
                            None)
                if pick is None:
                    pick = next((i for i in allowed
                                 if _module(ids[i]) == here), allowed[0])
            module = _module(ids[pick])
            if module in GROUPED_MODULES:
                return [i for i in self.pending if _module(ids[i]) == module]
            return [pick]

        def _send_tests(self, node, num):
            for _ in range(num):
                if not self.pending:
                    return
                picks = self._pick(node)
                for i in picks:
                    self.pending.remove(i)
                self.node2pending[node].extend(picks)
                node.send_runtest_some(picks)

    return OneAtATime(config, log)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """After a test module, a worker past ``MAPS_RELEASE`` memory maps
    drops JAX's compiled programs (see the module docstring)."""
    yield
    if "jax" not in sys.modules:
        return
    try:
        with open("/proc/self/maps") as f:
            maps = sum(1 for _ in f)
    except OSError:
        return
    if maps > MAPS_RELEASE:
        sys.modules["jax"].clear_caches()
        gc.collect()
