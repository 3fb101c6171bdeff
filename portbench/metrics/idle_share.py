"""Share of the traced window, in percent, in which no kernel, copy or
fill ran on the device: the union of their intervals in the device-only
profile of one list against that list's wall time."""


def read(trace):
    device = trace["device"]
    if device["window_s"] <= 0 or device["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - device["busy_s"] / device["window_s"])
