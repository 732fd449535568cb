"""idle_share (%): 1 - the device's busy time (the union of its
operations in the device-only profile) over that window's host-clock
length."""


def read(trace):
    if not trace.busy_s or not trace.window_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
