"""The port's copy of ``distributed/fault.py`` against the JAX package's:
the straggler watchdog on the same clock, and the elastic mesh shapes."""
import itertools

import pytest

from repro.distributed import fault as jf
from repro_torch.distributed import fault as tf


def _clock(steps):
    state = {"t": 0.0, "i": 0}

    def now():
        state["t"] += steps[state["i"] % len(steps)]
        state["i"] += 1
        return state["t"]

    return now


DURATIONS = [
    [1.0] * 12,
    [1.0] * 9 + [5.0] + [1.0] * 4,             # one straggler
    [1.0] * 8 + [5.0] * 20,                    # persistent slowdown
    [0.5, 1.5] * 6 + [3.2, 3.0, 2.9],          # at the tolerance's edge
    [2.0] * 4 + [9.0],                         # too few samples to judge
]


@pytest.mark.parametrize("durations", DURATIONS)
@pytest.mark.parametrize("tolerance,window", [(2.0, 32), (3.0, 8)])
def test_watchdog_matches_reference(durations, tolerance, window):
    """Start/stop with a fake clock: the same flags, window and median."""
    steps = []
    for d in durations:
        steps += [0.0, d]
    dogs = [mod.StepWatchdog(tolerance=tolerance, window=window,
                             timer=_clock(steps)) for mod in (tf, jf)]
    for step in range(len(durations)):
        got = [d.start(step) or d.stop() for d in dogs]
        assert got[0] == got[1]
    port, ref = dogs
    assert port.flagged == ref.flagged
    assert list(port.durations) == list(ref.durations)
    assert port.median_s == ref.median_s


def test_watchdog_flags_persistent_slowdown_and_resets():
    clock = _clock([0.0, 1.0] * 9 + [0.0, 5.0] * 20)
    wd = tf.StepWatchdog(tolerance=2.0, timer=clock)
    for step in range(29):
        wd.start(step)
        wd.stop()
    # the slowdown never enters the window, so every slow step is flagged
    assert [s for s, _ in wd.flagged] == list(range(9, 29))
    assert wd.median_s == 1.0
    wd.reset_window()
    assert wd.median_s is None and len(wd.flagged) == 20
    assert wd.stop() is None                    # stop without a start


GRIDS = [None, (16, 16), (16, 32), (12, 18), (15, 10), (1024, 1024, 2048),
         (1000, 1000), (7,)]


@pytest.mark.parametrize("grid", GRIDS)
def test_choose_fft_mesh_shape_matches_reference(grid):
    for n in range(1, 17):
        assert tf.choose_fft_mesh_shape(n, grid=grid) == \
            jf.choose_fft_mesh_shape(n, grid=grid)
    with pytest.raises(ValueError):
        tf.choose_fft_mesh_shape(0)


def test_choose_mesh_shape_matches_reference():
    for n, mp, pod in itertools.product(range(1, 33), (1, 2, 4, 8),
                                        (None, 8, 16)):
        try:
            want = jf.choose_mesh_shape(n, mp, pod_size=pod)
        except ValueError:
            with pytest.raises(ValueError):
                tf.choose_mesh_shape(n, mp, pod_size=pod)
            continue
        assert tf.choose_mesh_shape(n, mp, pod_size=pod) == want


def test_degraded_serving_shapes():
    """The shapes the serving tests rely on: 4 ranks serve as (2, 2); 3
    survivors of power-of-two grids serve as (2, 1)."""
    dims = (16, 16, 16, 32)
    assert tf.choose_fft_mesh_shape(4, grid=dims) == (2, 2)
    assert tf.choose_fft_mesh_shape(3, grid=dims) == (2, 1)
    assert tf.choose_fft_mesh_shape(3, grid=(12, 18)) == (3, 1)
