"""``device_idle_share``: 1 - the device's busy time in the traced cycle
(the union of its kernel and copy spans) over the wall of one cycle of
the measured window (its wall over its cycles), in %. The traced cycle
runs the same rounds as a cycle of the window, but its own wall is
stretched by the profiler's cost on the host, so it is not the divisor.
Layer: the device."""

from portbench import traffic


def read(readings):
    trace = readings["trace"]
    rounds = readings["rounds"]
    if not trace or not trace["device_events"] or not rounds \
            or readings["window_s"] <= 0:
        return None
    cycle_s = readings["window_s"] * traffic.cycle(readings["mix"]) \
        / len(rounds)
    return 100.0 * (1.0 - trace["busy_s"] / cycle_s)
