"""The whole step's share of the card's peak, in percent: the FLOPs the
audio of the list under the device-only profile needs
(``portbench.flops.recording_flops``, which counts no padding) over that
list's wall seconds times the H100 SXM's dense bf16 peak (989 TFLOP/s)."""

from portbench.flops import PEAK


def read(trace):
    device = trace["device"]
    if device["window_s"] <= 0 or device["flops"] <= 0:
        return None
    return 100.0 * device["flops"] / (device["window_s"]
                                      * PEAK["bf16_flops"])
