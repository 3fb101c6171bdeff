"""The LSTM recurrence kernel's share of its roofline, in percent: the
summed least time of the launches the traced list's chunks need (one per
layer and batch of chunks, ``portbench.flops.lstm_bound`` at the
pipeline's precision) over the summed device time, in the device-only profile, of the kernels named
``lstm_recurrence_kernel`` or ``lstm_stream_kernel`` in the trace."""

from portbench.flops import lstm_bound

NAMES = ("lstm_recurrence_kernel", "lstm_stream_kernel")


def read(trace):
    device = trace["device"]
    spent = sum(seconds for name, seconds in device["kernels"]
                if any(n in name for n in NAMES))
    lstm = device["lstm"]
    if spent <= 0 or not lstm["launches"]:
        return None
    bound = sum(lstm_bound(T, B, lstm["hidden"], lstm["directions"],
                           lstm["precision"]) for T, B in lstm["launches"])
    return 100.0 * bound / spent
